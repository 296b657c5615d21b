"""The port's apps (``emojivoice_tpu_torch/apps/``) on the CPU, against the
JAX package's.

``tests/test_apps.py``'s FeelMe and sink cases, ``test_game_ui.py``, and the
demo, Pepper and recording cases of ``test_streaming_and_demos.py`` run on
the port at a tiny size.  Beside them: FeelMe turns at temperature 0 (the
noise is multiplied by zero in both pipelines) on the same weights give the
JAX package's replies, speakers, spoken text, history and play calls, and
wavs within atol 1e-4 (the whole-slice bound of
``tests/test_torch_denoiser_pipeline.py``); the copied constants and the
feel_me parser equal the originals, but for ``flax`` → ``device`` and
``--cpu``.

The tiny model has 109 speakers, so that every emoji voice is a real row of
the speaker table in both pipelines (JAX clamps an index beyond the table,
PyTorch refuses it).
"""

import argparse
import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.apps import adapters as jax_ad
from emojivoice_tpu.apps import demos as jax_demos
from emojivoice_tpu.apps import feel_me as jax_feel_me
from emojivoice_tpu.apps import record_audio as jax_record_audio
from emojivoice_tpu.inference.pipeline import SynthesisPipeline as JaxPipeline
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.apps import adapters as ad
from emojivoice_tpu_torch.apps import demos, feel_me, game_ui, pepper, record_audio
from emojivoice_tpu_torch.apps.adapters import FileSink, ScriptedLLM
from emojivoice_tpu_torch.apps.feel_me import FeelMe
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax

torch.set_num_threads(2)

MEL_BUCKETS, TEXT_BUCKETS = (64, 128, 256), (64, 128)
WAV_TOL = 1e-4  # the whole tiny slice, port against JAX (tests/test_torch_denoiser_pipeline.py)


def tiny_root(module=cfglib):
    """The tiny model at 12 mels with 109 speakers and a ×16 vocoder, in the
    config classes of `module` (the port's or the JAX package's)."""
    voc = module.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
                               resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)), num_mels=12)
    model = module.ModelConfig(
        n_vocab=178, n_spks=109, spk_emb_dim=8, n_feats=12,
        encoder=module.EncoderConfig(n_feats=12, n_channels=16, filter_channels=32, n_heads=2, n_layers=2),
        duration_predictor=module.DurationPredictorConfig(filter_channels_dp=16),
        decoder=module.DecoderConfig(channels=(16, 16), attention_head_dim=8, num_heads=2, num_mid_blocks=1),
        cfm=module.CFMConfig(), data_statistics=module.DataStatistics(mel_mean=-5.5, mel_std=2.0))
    return module.RootConfig(model=model, vocoder=voc)


@functools.lru_cache(maxsize=1)
def tiny_port_pipe():
    """The port's tiny pipeline on the CPU, random weights (seed 0)."""
    return SynthesisPipeline.from_random(tiny_root(), seed=0, device="cpu", cleaners=("basic_cleaners",),
                                         mel_buckets=MEL_BUCKETS, text_buckets=TEXT_BUCKETS)


@pytest.fixture(scope="module")
def pipe():
    return tiny_port_pipe()


@pytest.fixture(scope="module")
def pipes():
    """The JAX pipeline at the tiny config and the port's on its weights."""
    root = tiny_root(jax_cfglib)
    model = FlaxMatcha(cfg=root.model)
    init = jax.jit(lambda rng: model.init(
        {"params": rng}, jnp.ones((1, 8), jnp.int32), jnp.array([8]), 16, 1, 1.0, jnp.array([0]), 1.0, None,
        jnp.zeros((1, 16, 12)), method=FlaxMatcha.synthesise))
    params = jax.device_get(init(jax.random.PRNGKey(0)))
    voc_params = jax.device_get(FlaxHiFiGAN(cfg=root.vocoder).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 12))))
    jp = JaxPipeline(root.model, params, root.vocoder, voc_params, cleaners=("basic_cleaners",),
                     mel_buckets=MEL_BUCKETS, text_buckets=TEXT_BUCKETS)
    port_root = tiny_root()
    pp = SynthesisPipeline.from_state_dicts(
        port_root.model, matcha_state_dict_from_flax(params, port_root.model), port_root.vocoder,
        hifigan_state_dict_from_flax(voc_params, port_root.vocoder), cleaners=("basic_cleaners",),
        mel_buckets=MEL_BUCKETS, text_buckets=TEXT_BUCKETS, device="cpu")
    return jp, pp


class SpySink:
    def __init__(self):
        self.played = []

    def play(self, wav, sample_rate):
        self.played.append((np.asarray(wav, np.float32).copy(), sample_rate))


# ------------------------------------------------------------------- FeelMe against the JAX package's

REPLIES = ["The robot smiled widely. 😁", "One tiny tale. Then another tale follows after it. 😭", "🤔"]


def xla_prefix_sums(monkeypatch):
    """The port's ``generate_path`` on XLA's prefix sums of the durations.

    The reference scales durations after the ceil (``ceil(w) · length_scale``,
    the fork's quirk, kept by both packages), so at a speaking rate of 0.8 the
    durations are multiples of 0.8 whose prefix sums land on whole frames.
    There XLA's ``cumsum`` on the CPU and PyTorch's round to neighbouring
    floats (12.000001 against 12.0, whose float64 sum rounds to 12.0), and
    one frame moves to the next phone, which the decoder's attention carries
    into every frame.  Both packages compute the same function; the tests
    hold the port to the JAX package's arithmetic elsewhere, so here the
    port's alignment takes XLA's sums."""
    from emojivoice_tpu_torch.models import matcha
    from emojivoice_tpu_torch.utils import masks

    def generate_path(duration, mask):
        cum = torch.from_numpy(np.array(jnp.cumsum(jnp.asarray(duration.numpy()), axis=1)))
        return masks.generate_path(torch.diff(cum, dim=1, prepend=torch.zeros_like(cum[:, :1])), mask)

    monkeypatch.setattr(matcha, "generate_path", generate_path)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("speaking_rate", [0.8, 1.0])
def test_feel_me_turns_equal_the_jax_packages(pipes, pipelined, speaking_rate, monkeypatch):
    """Three turns at temperature 0 (a one-sentence reply, a two-sentence one
    that ``choose_strategy`` sends down ``pipelined`` at 24 characters a
    segment, an emoji alone): the same replies, speakers, spoken text and
    history, the same play calls and lengths, wavs within 1e-4.  At FeelMe's
    own speaking rate of 0.8 the port aligns on XLA's prefix sums (see
    ``xla_prefix_sums``); at 1.0 the durations are whole frames and the port
    runs as it is."""
    jp, pp = pipes
    if speaking_rate == 0.8:
        xla_prefix_sums(monkeypatch)
    kw = dict(steps=2, temperature=0.0, speaking_rate=speaking_rate, language=None, pipelined=pipelined,
              segment_chars=24)
    ours = FeelMe(pp, asr=ad.ConsoleASR(), llm=ScriptedLLM(REPLIES), sink=SpySink(), **kw)
    theirs = jax_feel_me.FeelMe(jp, asr=jax_ad.ConsoleASR(), llm=jax_ad.ScriptedLLM(REPLIES), sink=SpySink(), **kw)
    for user in ("tell me a story", "go on", "and then?"):
        assert ours.turn(user) == theirs.turn(user)
    assert ours.history == theirs.history and len(ours.history) == 6
    assert [(len(w), sr) for w, sr in ours.sink.played] == [(len(w), sr) for w, sr in theirs.sink.played]
    assert len(ours.sink.played) == (5 if pipelined else 3)  # two segments and the gap between them
    for (a, _), (b, _) in zip(ours.sink.played, theirs.sink.played):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=WAV_TOL)


def test_prefix_sums_of_scaled_durations_round_apart():
    """The one difference ``xla_prefix_sums`` takes away: on durations that
    are multiples of 0.8, XLA's and PyTorch's float32 prefix sums differ in
    the last place at whole frames, and PyTorch's is the rounded float64 sum."""
    w = np.array([[0.8, 2.4, 1.6, 1.6, 2.4, 0.8, 1.6, 0.8]], np.float32)  # a reply's first durations
    ours = torch.cumsum(torch.from_numpy(w), dim=1).numpy()
    theirs = np.asarray(jnp.cumsum(jnp.asarray(w), axis=1))
    exact = np.cumsum(w.astype(np.float64), axis=1).astype(np.float32)
    np.testing.assert_array_equal(ours, exact)
    assert ours[0, -1] == 12.0 and theirs[0, -1] > 12.0
    np.testing.assert_allclose(ours, theirs, rtol=2e-7)


def test_copied_constants_equal_the_jax_packages():
    assert feel_me.PROMPT == jax_feel_me.PROMPT
    assert demos.GAME_PROMPT == jax_demos.GAME_PROMPT
    assert demos.STORY_DEFAULT_SPK == jax_demos.STORY_DEFAULT_SPK == 12
    assert record_audio.EMOTION_EMOJIS == jax_record_audio.EMOTION_EMOJIS
    assert record_audio.RECORD_SR == jax_record_audio.RECORD_SR
    assert game_ui.TYPEWRITER_DELAY_S == 0.02 and game_ui.WIN_WIDTH == 2000
    assert ScriptedLLM().replies == jax_ad.ScriptedLLM().replies
    msgs = ad.build_messages("sys", [{"role": "user", "content": "a"}], "b")
    assert msgs == jax_ad.build_messages("sys", [{"role": "user", "content": "a"}], "b")


def _jax_feel_me_parser():
    """The parser the JAX package's ``feel_me.main`` builds, caught before it parses."""
    caught = []

    class Caught(Exception):
        pass

    def catch(self, *a, **kw):
        caught.append(self)
        raise Caught

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(Caught):
            jax_feel_me.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return caught[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, tuple(a.choices) if a.choices else None, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_feel_me_parser_equals_the_jax_packages():
    ours, theirs = _options(feel_me.build_parser()), _options(_jax_feel_me_parser())
    assert ours.pop("cpu") == (("--cpu",), False, None, None, 0)
    for dest in ("asr", "llm"):
        strings, default, choices, kind, nargs = theirs[dest]
        theirs[dest] = (strings, default, tuple("device" if c == "flax" else c for c in choices), kind, nargs)
    assert ours == theirs


def test_feel_me_main_runs_on_the_asked_device(monkeypatch):
    """``main --cpu`` builds the pipeline and the device adapters on the CPU
    and runs the loop; without ``--cpu`` they are asked for the card."""
    built, pipe = [], tiny_port_pipe()
    monkeypatch.setattr(SynthesisPipeline, "from_random",
                        classmethod(lambda cls, **kw: built.append(("pipe", kw["device"])) or pipe))
    from emojivoice_tpu_torch.apps import torch_adapters

    class Fake:
        needs_audio = False

        def __init__(self, model_name, device):
            built.append((model_name, device))

    monkeypatch.setattr(torch_adapters, "TorchWhisperASR", Fake)
    monkeypatch.setattr(torch_adapters, "TorchChatLM", Fake)
    ran = []
    monkeypatch.setattr(FeelMe, "run", lambda self: ran.append((type(self.asr), type(self.llm), type(self.sink))))
    assert feel_me.main(["--cpu", "--random_init", "--asr", "device", "--llm", "device"]) == 0
    assert built == [("pipe", "cpu"), ("openai/whisper-tiny.en", "cpu"), ("gpt2", "cpu")]
    assert ran[0][:2] == (Fake, Fake)
    built.clear()
    assert feel_me.main(["--random_init", "--asr", "console", "--llm", "scripted"]) == 0
    assert built == [("pipe", "cuda")] and ran[1][:2] == (ad.ConsoleASR, ScriptedLLM)


# ------------------------------------------------------------------- tests/test_apps.py's cases

def test_feel_me_turn(pipe, tmp_path):
    sink = FileSink(str(tmp_path))
    app = FeelMe(pipe, asr=None, llm=ScriptedLLM(["The robot smiled widely. 😁", "😭"]), sink=sink, steps=2,
                 language=None)
    response, spk, spoken = app.turn("tell me a story")
    assert spk == 18 and "😁" not in spoken
    assert sink.count == 1 and sink.last_path.exists()
    response, spk, spoken = app.turn("go on")  # emoji-only reply → "nice" in that voice
    assert spk == 103 and spoken == "nice"
    assert sink.count == 2 and len(app.history) == 4


def test_feel_me_pipelined_multisentence(pipe, tmp_path):
    reply = "One tiny tale. Then another tale follows after it. 😁"
    sink = FileSink(str(tmp_path))
    app = FeelMe(pipe, asr=None, llm=ScriptedLLM([reply]), sink=sink, steps=2, language=None, segment_chars=24)
    _, spk, spoken = app.turn("hi")
    assert spk == 18 and "😁" not in spoken
    assert sink.count >= 2  # segments played one by one, in order
    sink2 = FileSink(str(tmp_path / "off"))
    FeelMe(pipe, asr=None, llm=ScriptedLLM([reply]), sink=sink2, steps=2, language=None, pipelined=False).turn("hi")
    assert sink2.count == 1  # pipelining off → one blob


def test_file_sink_writes_valid_wav(tmp_path):
    from scipy.io import wavfile

    sink = FileSink(str(tmp_path), pattern="t{i}.wav")
    sink.play(np.zeros(100, np.float32), 22050)
    sr, data = wavfile.read(tmp_path / "t0.wav")
    assert sr == 22050 and len(data) == 100


def test_feel_me_run_records_before_transcribing(pipe, tmp_path, monkeypatch):
    """The loop records push-to-talk audio into record_path and hands that
    file to a needs_audio ASR (reference feel_me.py:280-283)."""
    wav_path = str(tmp_path / "output.wav")

    class FakeRecorder:
        calls = 0

        def record(self, path):
            from scipy.io import wavfile

            self.calls += 1
            wavfile.write(path, 22050, np.zeros(2205, np.int16))
            return True

    class FileASR:
        needs_audio = True

        def __init__(self):
            self.paths = []

        def transcribe(self, path):
            assert os.path.exists(path)
            self.paths.append(path)
            return "hello robot" if len(self.paths) == 1 else "end session"

    rec, asr = FakeRecorder(), FileASR()
    app = FeelMe(pipe, asr=asr, llm=ScriptedLLM(["okay then 🙂"]), sink=FileSink(str(tmp_path)), recorder=rec,
                 record_path=wav_path, steps=2, language=None)
    monkeypatch.setattr("builtins.input", lambda *a: "")
    app.run()
    assert rec.calls == 2 and asr.paths == [wav_path, wav_path]


def test_feel_me_needs_audio_without_recorder_raises(monkeypatch, tmp_path):
    class FileASR:
        needs_audio = True

        def transcribe(self, path):  # noqa: ARG002
            return ""

    monkeypatch.setattr(ad, "default_recorder", lambda: None)
    with pytest.raises(RuntimeError, match="recorder"):
        FeelMe(pipeline=None, asr=FileASR(), llm=ScriptedLLM(), sink=FileSink(str(tmp_path)))


# ------------------------------------------------------------------- tests/test_game_ui.py's cases

def test_console_fallback_when_pygame_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "pygame", None)
    assert not game_ui.pygame_available()
    ui = game_ui.make_ui(window=True)
    assert isinstance(ui, game_ui.ConsoleUI)
    assert ui.pump()
    ui.typewriter("hello")
    ui.notice("notice")
    ui.clear_text()
    ui.close()
    assert not ui.pump()


def test_game_window_real_pygame_headless(monkeypatch):
    pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    ui = game_ui.make_ui(window=True, char_delay=0.0)
    if isinstance(ui, game_ui.ConsoleUI):
        pytest.skip("pygame present but dummy video driver unavailable")
    try:
        assert ui.pump()
        ui.typewriter("hello there!")
        ui.notice("I didn't hear anything, try recording again...")
        ui.clear_text()
    finally:
        ui.close()
    assert not ui.pump()


def _fake_pygame():
    """The pygame API surface GameWindow uses, counting its calls."""
    pg = types.ModuleType("pygame")
    calls = {"update": 0, "rects": [], "blits": [], "quit": 0}

    class Rect:
        def __init__(self, w, h):
            self.w, self.h = w, h
            self.topleft = (0, 0)

    class Surface:
        def __init__(self, w=10, h=10):
            self._w, self._h = w, h

        def get_rect(self):
            return Rect(self._w, self._h)

        def get_width(self):
            return self._w

        def fill(self, color):
            pass

        def blit(self, img, rect):
            calls["blits"].append(rect)

    class Font:
        def render(self, text, aa, color):
            calls.setdefault("rendered", []).append(text)
            return Surface(len(text), 10)

    class Clock:
        def tick(self, fps):
            calls.setdefault("ticks", []).append(fps)

    pg.init = lambda: None
    pg.quit = lambda: calls.__setitem__("quit", calls["quit"] + 1)
    pg.QUIT = 256
    pg.display = types.SimpleNamespace(set_mode=lambda size: Surface(*size), set_caption=lambda s: None,
                                       update=lambda: calls.__setitem__("update", calls["update"] + 1))
    pg.draw = types.SimpleNamespace(rect=lambda screen, color, rect: calls["rects"].append(rect))
    pg.font = types.SimpleNamespace(SysFont=lambda name, size: Font())
    pg.event = types.SimpleNamespace(get=lambda: [])
    pg.time = types.SimpleNamespace(Clock=Clock)
    pg.image = types.SimpleNamespace(load=lambda p: Surface())
    return pg, calls


def test_game_window_typewriter_with_fake_pygame(monkeypatch):
    pg, calls = _fake_pygame()
    monkeypatch.setitem(sys.modules, "pygame", pg)
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")  # pass the headless guard
    assert game_ui.pygame_available()
    ui = game_ui.make_ui(window=True, char_delay=0.0)
    assert isinstance(ui, game_ui.GameWindow)
    assert ui.pump()
    ui.typewriter("hi!")
    assert calls["rendered"] == ["h", "hi", "hi!"]  # one render per revealed char
    assert len(calls["rects"]) >= 3
    ui.notice("I didn't hear anything, try recording again...")
    assert calls["rendered"][-1].startswith("I didn't hear")
    ui.close()
    assert calls["quit"] == 1 and not ui.pump()


class LinesASR:
    def __init__(self, *lines):
        self.lines = iter(lines)

    def transcribe(self, _):
        return next(self.lines)


def test_game_loop_drives_ui(pipe, tmp_path):
    class RecordingUI(game_ui.ConsoleUI):
        def __init__(self):
            super().__init__()
            self.typed, self.notices = [], []

        def typewriter(self, text):
            self.typed.append(text)

        def notice(self, text):
            self.notices.append(text)

    ui = RecordingUI()
    n = demos.run_game(pipe, steps=2, llm=ScriptedLLM(), asr=LinesASR("once upon a time", "", "end session"),
                       sink=FileSink(str(tmp_path)), ui=ui)
    assert n == 1 and len(ui.typed) == 1 and len(ui.notices) == 1 and ui.closed


def test_game_sequencing_matches_reference(pipe, tmp_path):
    """The reply is typed first, the audio plays with the text on screen, and
    the bar clears only after playback (case3_game/main.py:324-368)."""
    events = []

    class OrderedUI(game_ui.ConsoleUI):
        def typewriter(self, text):
            events.append("type")

        def clear_text(self):
            events.append("clear")

    class OrderedSink(FileSink):
        def play(self, wav, sr):
            events.append("play")
            return super().play(wav, sr)

    n = demos.run_game(pipe, steps=2, llm=ScriptedLLM(), asr=LinesASR("a story begins", "end session"),
                       sink=OrderedSink(str(tmp_path)), ui=OrderedUI())
    assert n == 1 and events == ["type", "play", "clear"]
    assert game_ui.ConsoleUI.echoes_text and not game_ui.GameWindow.echoes_text


# ------------------------------------------------------------------- test_streaming_and_demos.py's cases

def test_demo_render_and_story(pipe, tmp_path):
    script = tmp_path / "script.txt"
    script.write_text('Byte: 😎 "No worries. I will handle it."\nAlex: plain line\n')
    out = tmp_path / "out"
    demos.render_script(pipe, str(script), str(out), steps=2)
    assert (out / "1.wav").exists() and (out / "2.wav").exists()
    story = tmp_path / "story.txt"
    story.write_text("Once upon a time 😎.\nA second line 😭!\n")
    out2 = tmp_path / "story_out"
    out2.mkdir()
    demos.run_story(pipe, str(story), str(out2), play=False, steps=2)
    assert (out2 / "to_play-0.wav").exists() and (out2 / "to_play-1.wav").exists()


def test_demo_game_loop(pipe, tmp_path):
    n = demos.run_game(pipe, voice="male", steps=2, llm=ScriptedLLM(),
                       asr=LinesASR("the knight entered the cave", "end session"), sink=FileSink(str(tmp_path)))
    assert n == 1 and len(list(tmp_path.glob("*.wav"))) == 1


def test_pepper_local_roundtrip(tmp_path):
    from scipy.io import wavfile

    src = tmp_path / "a.wav"
    wavfile.write(src, 22050, (np.sin(np.linspace(0, 50, 1000)) * 0.5).astype(np.float32))
    sr, data = wavfile.read(pepper.format_audio_16bit(str(src)))
    assert data.dtype == np.int16 and sr == 22050
    script = tmp_path / "s.txt"
    script.write_text("line one\nline two\n")
    for i in range(2):
        wavfile.write(tmp_path / f"to_play-{i}.wav", 22050, np.zeros(500, np.float32))
    transport = pepper.LocalTransport(str(tmp_path / "played"))
    transport.sink = FileSink(str(tmp_path / "played"))
    assert pepper.run_storytelling(transport, str(tmp_path), str(script), timeout=5) == 2
    assert len(transport.played) == 2
    with pytest.raises(TimeoutError):
        pepper.wait_for_file_update(str(tmp_path / "never.wav"), timeout=0.3)


def test_record_audio_tools(tmp_path, rng):
    from scipy.io import wavfile

    assert len(record_audio.EMOTION_EMOJIS) == 11
    scripts = tmp_path / "scripts"
    scripts.mkdir()
    (scripts / "script-neutral.txt").write_text("first sentence\nsecond sentence\n")
    rec = tmp_path / "recordings" / "neutral"
    rec.mkdir(parents=True)
    for i in range(2):
        wavfile.write(rec / f"paige-neutral-{i}.wav", 44100, (rng.normal(size=22050) * 3000).astype(np.int16))
    record_audio.resample_tree(tmp_path / "recordings", 22050)
    sr, _ = wavfile.read(rec / "paige-neutral-0.wav")
    assert sr == 22050
    rows = record_audio.make_filelist(tmp_path / "recordings", scripts, {"neutral": 12}, tmp_path / "train.txt")
    assert len(rows) == 2 and rows[0].endswith("|12|first sentence")
    # the port's tools write what the JAX package's write from the same tree
    theirs = jax_record_audio.make_filelist(tmp_path / "recordings", scripts, {"neutral": 12}, tmp_path / "j.txt")
    assert rows == theirs and (tmp_path / "train.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_tiny_root_equals_in_both_packages():
    assert cfglib.to_dict(tiny_root()) == jax_cfglib.to_dict(tiny_root(jax_cfglib))
