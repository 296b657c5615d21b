"""The rank program of ``tests/test_torch_parallel.py``: every rank of a gloo
group on the CPU runs the cases named in ``task.json`` on the inputs in
``inputs.npz`` and writes ``rank<r>.npz``.  Imports the port only (no JAX):
the JAX side runs in the test's own process.

Cases (each builds its own mesh over the group):

* ``ddp_step`` / ``tp_step``: one ``train_step`` of the tiny model from the
  given weights on this rank's rows of the global batch, data parallel over
  every rank or tensor parallel over every rank → the metrics and the whole
  parameters after the step;
* ``tp_synth``: ``MatchaTTS.synthesise`` and a narrow HiFi-GAN, split over
  every rank on the model axis and whole → both outputs;
* ``dp_pipeline``: a data-parallel ``SynthesisPipeline`` and a meshless one on
  the same texts and seeds (a batch that splits and one that does not);
* ``dcp``: the tensor-parallel state after its step saved through
  ``torch.distributed.checkpoint`` and restored into a state built from
  another seed → whether every local tensor came back to the bit;
* ``conformer_ddp``: one data-parallel step of a conformer model → metrics,
  parameters and BatchNorm buffers;
* ``vocoder_ddp``: one data-parallel GAN step of a narrow generator →
  metrics and the generator's parameters.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from emojivoice_tpu_torch import config as cfglib

TEXTS = ["shard me number zero", "one more", "the third row is longer than the rest", "four"]


def no_dropout_cfg(cfg: cfglib.ModelConfig) -> cfglib.ModelConfig:
    """The config's three dropout rates set to 0."""
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, p_dropout=0.0),
        duration_predictor=dataclasses.replace(cfg.duration_predictor, p_dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0))


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """Every ``nn.Dropout`` at 0, the prenet's fixed 0.5 included."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def conformer_cfg(cfg: cfglib.ModelConfig) -> cfglib.ModelConfig:
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, down_block_type="conformer", mid_block_type="conformer", up_block_type="conformer"))


def narrow_vocoder() -> cfglib.HiFiGANConfig:
    return cfglib.HiFiGANConfig(upsample_initial_channel=64)


def batch_of(inputs: dict) -> dict:
    return {k: torch.from_numpy(inputs[k]).long() if inputs[k].dtype.kind == "i" else torch.from_numpy(inputs[k])
            for k in ("x", "x_lengths", "y", "y_lengths", "spks")}


def model_from(cfg, sd: dict):
    from emojivoice_tpu_torch.models.matcha import MatchaTTS

    model = MatchaTTS(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return no_dropout(model)


def one_step(cfg, sd, inputs, mesh, seed):
    from emojivoice_tpu_torch.parallel.mesh import pad_batch_to_multiple, shard_batch
    from emojivoice_tpu_torch.parallel.tp import full_state_dict
    from emojivoice_tpu_torch.training.state import create_train_state, train_step

    state = create_train_state(cfg, cfglib.OptimizerConfig(), device="cpu", model=model_from(cfg, sd), mesh=mesh)
    global_np = {k: v.numpy() for k, v in batch_of(inputs).items()}
    local = shard_batch(mesh, pad_batch_to_multiple(global_np, mesh.size("data")))
    m = train_step(state, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in local.items()}, seed)
    full = full_state_dict(state.model, mesh)
    return state, {k: float(v) for k, v in m.items()}, {k: v.numpy() for k, v in full.items()}


def run(rank: int, world: int, port: int, task_dir: str) -> None:
    import torch.distributed as dist

    from emojivoice_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from emojivoice_tpu_torch.parallel.tp import make_mesh_2d

    torch.set_num_threads(1)
    task = json.loads(open(os.path.join(task_dir, "task.json")).read())
    inputs = dict(np.load(os.path.join(task_dir, "inputs.npz")))
    sd = {k[3:]: v for k, v in inputs.items() if k.startswith("sd.")}
    cfg = no_dropout_cfg(cfglib.get_preset("tiny").model)
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    out = {}
    try:
        for case in task["cases"]:
            if case in ("ddp_step", "tp_step"):
                mesh = make_mesh(world, device="cpu") if case == "ddp_step" else make_mesh_2d(1, world, device="cpu")
                state, metrics, full = one_step(cfg, sd, inputs, mesh, task["seed"])
                out.update({f"{case}.m.{k}": np.float64(v) for k, v in metrics.items()})
                out.update({f"{case}.p.{k}": v for k, v in full.items()})
                if case == "tp_step" and "dcp" in task["cases"]:
                    out["dcp.equal"] = np.bool_(dcp_round_trip(state, cfg, mesh, task_dir))
            elif case == "tp_synth":
                out.update(tp_synth(cfg, sd, inputs, make_mesh_2d(1, world, device="cpu")))
            elif case == "dp_pipeline":
                out.update(dp_pipeline(make_mesh(world, device="cpu")))
            elif case == "conformer_ddp":
                conf = conformer_cfg(cfg)
                state, metrics, full = one_step(conf, {k[4:]: v for k, v in inputs.items() if k.startswith("csd.")},
                                                inputs, make_mesh(world, device="cpu"), task["seed"])
                out.update({f"{case}.m.{k}": np.float64(v) for k, v in metrics.items()})
                out.update({f"{case}.p.{k}": v for k, v in full.items()})
            elif case == "vocoder_ddp":
                out.update(vocoder_ddp(inputs, make_mesh(world, device="cpu")))
            dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(task_dir, f"rank{rank}.npz"), **out)


def dcp_round_trip(state, cfg, mesh, task_dir: str) -> bool:
    """Save the state through DCP, restore it into a state from another seed."""
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.training.state import create_train_state

    mgr = CheckpointManager(os.path.join(task_dir, "ckpts"), sharded=True)
    mgr.save(state.step, state.sharded_state_dict(), cfg=cfglib.RootConfig(model=cfg))
    other = create_train_state(cfg, cfglib.OptimizerConfig(), seed=99, device="cpu", mesh=mesh)
    other.load_sharded_state_dict(mgr.restore(template=other.sharded_state_dict()))
    same = other.step == state.step
    for (k, a), (_, b) in zip(state.model.state_dict().items(), other.model.state_dict().items()):
        same &= torch.equal(a, b)
    for pa, pb in zip(state.model.parameters(), other.model.parameters()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            same &= torch.equal(state.optimizer.state[pa][k], other.optimizer.state[pb][k])
    return bool(same)


@torch.no_grad()
def tp_synth(cfg, sd, inputs, mesh) -> dict:
    from emojivoice_tpu_torch.parallel.tp import shard_params
    from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    x, xl = torch.from_numpy(inputs["synth_x"]).long(), torch.from_numpy(inputs["synth_xl"]).long()
    z, spk = torch.from_numpy(inputs["synth_z"]), torch.tensor([1])
    whole = model_from(cfg, sd).eval()
    split = shard_params(model_from(cfg, sd).eval(), mesh)
    ref = whole.synthesise(x, xl, z.shape[1], 4, z, spk)["mel"]
    mel = split.synthesise(x, xl, z.shape[1], 4, z, spk)["mel"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gen = HiFiGANGenerator(narrow_vocoder()).eval()
    mel_in = torch.from_numpy(inputs["voc_mel"])
    wav_ref = gen(mel_in)
    shard_params(gen, mesh)
    return {"tp_synth.mel": mel.numpy(), "tp_synth.mel_ref": ref.numpy(), "tp_synth.wav": gen(mel_in).numpy(),
            "tp_synth.wav_ref": wav_ref.numpy()}


def dp_pipeline(mesh) -> dict:
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    voc = cfglib.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
                               resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))
    root = cfglib.RootConfig(model=cfglib.get_preset("tiny").model, vocoder=voc)
    kw = dict(seed=0, device="cpu", cleaners=("basic_cleaners",), mel_buckets=(128, 256, 512, 1024), text_buckets=(64, 128))
    base = SynthesisPipeline.from_random(root, **kw)
    dp = SynthesisPipeline.from_random(root, mesh=mesh, **kw)
    out = {}
    for name, n in (("even", 4), ("odd", 3)):
        args = dict(spks=list(range(n)), n_timesteps=2, seed=list(range(50, 50 + n)))
        for tag, pipe in (("ref", base), ("dp", dp)):
            for i, r in enumerate(pipe.synthesise(TEXTS[:n], **args)):
                out[f"dp_pipeline.{name}.{tag}.{i}"] = r.wav
    return out


def vocoder_ddp(inputs, mesh) -> dict:
    from emojivoice_tpu_torch.parallel.mesh import shard_batch
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state, vocoder_train_step

    cfg = narrow_vocoder()
    state = create_vocoder_state(cfg, seed=3, weight_norm=False, device="cpu", mesh=mesh)
    batch = shard_batch(mesh, {"mel": inputs["gan_mel"], "wav": inputs["gan_wav"]})
    m = vocoder_train_step(state, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    out = {f"vocoder_ddp.m.{k}": np.float64(float(v)) for k, v in m.items()}
    out.update({f"vocoder_ddp.p.{k}": v.detach().numpy() for k, v in state.gen.state_dict().items()})
    return out


def one_device(case: str, inputs: dict, seed: int) -> dict:
    """The same case's one-device numbers, in the calling process, no group."""
    from emojivoice_tpu_torch.training.state import create_train_state, train_step
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state, vocoder_train_step

    if case == "vocoder_ddp":
        state = create_vocoder_state(narrow_vocoder(), seed=3, weight_norm=False, device="cpu")
        m = vocoder_train_step(state, {"mel": torch.from_numpy(inputs["gan_mel"]),
                                       "wav": torch.from_numpy(inputs["gan_wav"])})
        return {"m": {k: float(v) for k, v in m.items()},
                "p": {k: v.detach().numpy() for k, v in state.gen.state_dict().items()}}
    cfg = conformer_cfg(no_dropout_cfg(cfglib.get_preset("tiny").model))
    sd = {k[4:]: v for k, v in inputs.items() if k.startswith("csd.")}
    state = create_train_state(cfg, cfglib.OptimizerConfig(), device="cpu", model=model_from(cfg, sd))
    m = train_step(state, batch_of(inputs), seed)
    return {"m": {k: float(v) for k, v in m.items()},
            "p": {k: v.detach().numpy() for k, v in state.model.state_dict().items()}}


def launch(cases, world: int, inputs: dict, seed: int, timeout_s: float = 240.0) -> list:
    """Run `cases` on `world` gloo ranks → each rank's outputs."""
    from emojivoice_tpu_torch.parallel.mesh import free_port, spawn

    with tempfile.TemporaryDirectory() as task_dir:
        with open(os.path.join(task_dir, "task.json"), "w") as f:
            json.dump({"cases": list(cases), "seed": seed}, f)
        np.savez(os.path.join(task_dir, "inputs.npz"), **inputs)
        spawn(run, world, (world, free_port(), task_dir), timeout_s=timeout_s)
        return [dict(np.load(os.path.join(task_dir, f"rank{r}.npz"))) for r in range(world)]
