"""The port's ``utils/observability.py`` against the JAX package's copy: for
the same calls the writers leave the same files, byte for byte (the
``scalars.jsonl`` sidecar, ``metrics.csv``, the PNG of an image), and the
factory and its backends behave alike.  Event files are each package's own
(tensorflow's there, tensorboard's protocol buffers in plain file I/O here,
read back record by record): the port writes them where the ``tensorboard``
package imports and falls back to the jsonl sidecar alone where it does not,
as the JAX writer does without tensorflow; it never imports TensorFlow, so
TensorFlow's own summaries still work after it in the same process.

The span recorder, the port's own: nothing recorded while it is off;
nesting, causes, ids and threads while it is on; the bounded buffer; many
threads at once."""

import json
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from emojivoice_tpu.utils import observability as jax_obs
from emojivoice_tpu_torch.utils import observability as obs

torch.set_num_threads(2)


def _drive(module, log_dir):
    """The same calls on one package's writers: a tensorboard writer and a
    CSV logger behind ``make_logger``, scalars whose tags appear late, an
    image, an empty image, flushes between."""
    w = module.make_logger("tensorboard,csv", str(log_dir))
    rng = np.random.default_rng(0)
    w.scalar("train/loss", 2.0, step=1)
    w.scalar("train/lr", 1e-4, step=1)
    w.flush()
    w.scalar("train/loss", 1.5, step=2)
    w.scalar("val/loss", 3.25, step=2)  # a tag after the header reached the disk
    w.image("val/mel_0", rng.normal(size=(12, 40)).astype(np.float32), step=2)
    w.image("val/mel_1", np.zeros((0, 12), np.float32), step=2)  # a degenerate render is skipped
    w.flush()
    w.scalar("probe/diagonality", 0.875, step=3)
    w.close()
    return w


@pytest.mark.parametrize("name", ["scalars.jsonl", "metrics.csv", "val_mel_0_2.png"])
def test_files_equal_the_jax_writers(tmp_path, name):
    _drive(jax_obs, tmp_path / "jax")
    _drive(obs, tmp_path / "port")
    ours, theirs = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
    assert ours == theirs and len(ours) > 0
    assert not (tmp_path / "port" / "val_mel_1_2.png").exists()


def _records(path):
    """The ``Event`` protocol buffers of an event file, each record's framing
    and checksums verified."""
    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

    data, events, at = path.read_bytes(), [], 0
    while at < len(data):
        (n,) = struct.unpack("<Q", data[at:at + 8])
        assert struct.unpack("<I", data[at + 8:at + 12])[0] == masked_crc32c(data[at:at + 8])
        body = data[at + 12:at + 12 + n]
        assert struct.unpack("<I", data[at + 12 + n:at + 16 + n])[0] == masked_crc32c(body)
        events.append(Event.FromString(body))
        at += 16 + n
    return events


def test_event_files_where_tensorboard_imports_and_jsonl_alone_where_not(tmp_path, monkeypatch):
    pytest.importorskip("tensorboard")
    w = obs.TensorBoardWriter(str(tmp_path / "tb"))
    assert w.event_files
    w.scalar("train/loss", 1.25, step=3)
    gray = np.linspace(0, 1, 24, dtype=np.float32).reshape(4, 6)
    w.image("val/mel_0", gray, step=3)
    w.close()
    (path,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    events = _records(path)
    assert events[0].file_version == "brain.Event:2"
    (scalar,) = events[1].summary.value
    assert (events[1].step, scalar.tag, scalar.simple_value) == (3, "train/loss", 1.25)
    (image,) = events[2].summary.value
    assert (image.tag, image.image.height, image.image.width) == ("val/mel_0", 4, 6)
    png = image.image.encoded_image_string
    assert png.startswith(b"\x89PNG") and zlib.decompress(png[png.index(b"IDAT") + 4:-16])[1:7] == bytes(
        np.round(gray[0] * 255).astype(np.uint8))
    monkeypatch.setitem(sys.modules, "tensorboard.compat.proto.event_pb2", None)  # an image without tensorboard
    w = obs.TensorBoardWriter(str(tmp_path / "plain"))
    assert not w.event_files
    w.scalar("train/loss", 1.0, step=1)
    w.close()
    assert not list((tmp_path / "plain").glob("events.out.tfevents.*"))
    assert json.loads((tmp_path / "plain" / "scalars.jsonl").read_text()) == {"tag": "train/loss", "value": 1.0,
                                                                             "step": 1}


def test_the_jax_writer_still_gets_tensorflow_after_the_ports(tmp_path):
    """The port's writer touches neither TensorFlow nor tensorboard's lazy
    TensorFlow module: TensorFlow's own summaries (the JAX writer's) work
    after it in the same process."""
    pytest.importorskip("tensorboard")
    port = obs.TensorBoardWriter(str(tmp_path / "port"))
    port.scalar("train/loss", 1.0, step=1)
    port.image("val/mel_0", np.ones((4, 6)), step=1)
    port.close()
    theirs = jax_obs.TensorBoardWriter(str(tmp_path / "jax"))
    theirs.scalar("train/loss", 1.0, step=1)
    theirs.close()
    assert (tmp_path / "jax" / "scalars.jsonl").exists()


def test_factory_and_backends_follow_the_jax_copy(tmp_path, capsys):
    assert obs.LOGGER_BACKENDS == jax_obs.LOGGER_BACKENDS
    assert obs.WandbLogger.available() == jax_obs.WandbLogger.available()
    if not obs.WandbLogger.available():  # gated: the factory warns and skips it
        w = obs.make_logger("tensorboard,csv,wandb", str(tmp_path / "multi"))
        assert isinstance(w, obs.MultiLogger) and len(w.writers) == 2
        assert "wandb" in capsys.readouterr().err
        w.close()
        assert isinstance(obs.make_logger("wandb", str(tmp_path / "fb")), obs.TensorBoardWriter)
    with pytest.raises(ValueError, match="unknown logger backend"):
        obs.make_logger("mlflow", str(tmp_path / "x"))
    assert isinstance(obs.make_logger("csv", str(tmp_path / "c")), obs.CSVLogger)
    assert isinstance(obs.make_logger(" TB ", str(tmp_path / "t")), obs.TensorBoardWriter)


def test_seed_nan_checks_rank_and_main_process_only():
    gen = obs.seed_everything(7)
    a = torch.randn(3)
    assert torch.equal(torch.randn(3, generator=gen), torch.randn(3, generator=torch.Generator().manual_seed(7)))
    obs.seed_everything(7)
    assert torch.equal(torch.randn(3), a)
    obs.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        obs.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    assert obs.is_main_process()  # no process group: rank 0
    calls = []
    obs.main_process_only(lambda: calls.append(1))()
    assert calls == [1]
    assert obs.get_logger("emojivoice_tpu_torch.test").handlers


def test_step_timer_and_trace_on_the_cpu(tmp_path):
    timer = obs.StepTimer()
    x = torch.ones(64, 64)
    for _ in range(2):
        with timer.measure(device="cpu"):
            x @ x
    s = timer.summary()
    assert s["n"] == 2 and s["median_s"] >= 0 and set(s) == {"mean_s", "median_s", "p90_s", "n"}
    assert obs.StepTimer().summary() == {}
    with obs.trace(str(tmp_path / "trace"), device="cpu") as prof:
        x @ x
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with obs.trace(str(tmp_path / "off"), enabled=False):
        x @ x
    assert not (tmp_path / "off").exists()


def test_step_timer_on_a_card_device_waits_for_it(monkeypatch):
    """``measure(device="cuda")`` synchronises that device before and after."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    timer = obs.StepTimer()
    with timer.measure(device="cuda:0"):
        pass
    assert synced == ["cuda:0", "cuda:0"]


# ---------------------------------------------------------------- the span recorder


@pytest.fixture
def recorder():
    """The recorder on, with an empty buffer; off and drained after the test."""
    obs.enable()
    try:
        yield obs
    finally:
        obs.disable()
        obs.drain()


def test_no_span_is_recorded_while_tracing_is_off():
    obs.disable()
    obs.drain()
    assert obs.begin("a", batch=1) is None
    obs.end(None)
    with obs.span("b", turn=2) as sp:
        assert sp is None
    assert obs.span("c") is obs.span("d")  # one shared do-nothing context: nothing made per site
    assert list(obs.spanned(iter([1, 2]), "e")) == [1, 2]
    assert obs.drain() == []


def test_spans_nest_on_their_thread_and_carry_their_ids(recorder):
    with obs.span("outer", batch=7, rids=[3, 4]) as outer:
        inner = obs.begin("inner", turn=2)
        obs.end(inner)
        obs.end(inner)  # a second end leaves the span as it was
        with obs.span(None):  # a None name records nothing
            with obs.span("leaf", segment=0):
                pass
    spans = {s["name"]: s for s in obs.drain()}
    assert set(spans) == {"outer", "inner", "leaf"}
    assert spans["outer"]["parent"] is None and spans["outer"]["id"] == outer.id
    assert spans["inner"]["parent"] == spans["leaf"]["parent"] == outer.id
    assert (spans["outer"]["batch"], spans["outer"]["rids"], spans["inner"]["turn"], spans["leaf"]["segment"]) == \
        (7, [3, 4], 2, 0)
    assert "turn" not in spans["outer"] and spans["outer"]["thread"] == threading.current_thread().name
    assert spans["outer"]["t0"] <= spans["inner"]["t0"] <= spans["inner"]["t1"] <= spans["leaf"]["t0"] \
        <= spans["leaf"]["t1"] <= spans["outer"]["t1"]
    assert obs.drain() == []  # drained once


def test_a_span_closed_out_of_order_leaves_the_stack(recorder):
    a = obs.begin("a")
    b = obs.begin("b")
    obs.end(a)  # b's site raised past its end
    with obs.span("c"):
        pass
    obs.end(b, keep=False)
    spans = {s["name"]: s for s in obs.drain()}
    assert set(spans) == {"a", "c"} and spans["c"]["parent"] == b.id
    with obs.span("d"):
        pass
    (d,) = obs.drain()
    assert d["parent"] is None


def test_spanned_records_each_item_and_not_the_end(recorder):
    def items():
        for i in range(3):
            with obs.span("child"):
                pass
            yield i

    assert list(obs.spanned(items(), "seg")) == [0, 1, 2]
    spans = obs.drain()
    segs = [s for s in spans if s["name"] == "seg"]
    assert [s["segment"] for s in segs] == [0, 1, 2]
    assert [s["parent"] for s in spans if s["name"] == "child"] == [s["id"] for s in segs]


def test_the_buffer_is_bounded_and_disable_keeps_what_it_holds(monkeypatch):
    monkeypatch.setattr(obs, "SPAN_CAPACITY", 4)
    obs.enable()
    try:
        for i in range(3):
            with obs.span(f"s{i}"):
                pass
        late = obs.begin("late")
        obs.disable()
        assert obs.begin("off") is None
        obs.end(late)  # opened while on: recorded when it closes
        assert obs.dropped() == 0
        assert [s["name"] for s in obs.drain()] == ["s0", "s1", "s2", "late"]
        obs.enable()
        for i in range(6):
            with obs.span(f"t{i}"):
                pass
        assert obs.dropped() == 2  # a full buffer turns the later spans away and counts them
        assert [s["name"] for s in obs.drain()] == ["t0", "t1", "t2", "t3"]
        obs.enable()
        assert obs.dropped() == 0
    finally:
        obs.disable()
        obs.drain()


def test_concurrent_threads_keep_their_own_stacks(recorder):
    """More threads than cores record nested spans at a short switch
    interval: every span is kept, ids are unique, and each child's cause is
    its own thread's outer span."""
    n_threads, per = 12, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(k):
            for i in range(per):
                with obs.span("outer", batch=k):
                    with obs.span("inner", batch=k):
                        pass

        threads = [threading.Thread(target=work, args=(k,), name=f"w{k}") for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    spans = obs.drain()
    assert len(spans) == 2 * n_threads * per and len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["thread"] == f"w{s['batch']}"
        if s["name"] == "inner":
            parent = by_id[s["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == s["thread"] and parent["t0"] <= s["t0"]
        else:
            assert s["parent"] is None
