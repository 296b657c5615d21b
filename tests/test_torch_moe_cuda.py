"""K3, the routed-expert CUDA kernels, against their plain version on the
card, at DeepSeek-V2-Lite's widths (H 2048, I 1408, 64 experts, top-6).

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  Imports no JAX, so it runs
where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_cuda.py -q

Tolerance: 1e-5 of the output's largest magnitude.  Both sides are f32
with TF32 off, but they sum each dot product (2048 or 1408 terms) in other
orders: K3 in lane-strided partial sums and a warp's shuffle tree, or down
one thread's 16-deep steps; cuBLAS in its own tiles.  The routed products
are then weighted and added in the same order on both sides.
"""

import pytest
import torch

from emojivoice_tpu_torch.ops import moe

H, I, E, K = 2048, 1408, 64, 6


@pytest.fixture(scope="module")
def stack():
    if not torch.cuda.is_available():
        pytest.skip("K3 is a CUDA kernel: it needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(3)
    w13 = torch.randn((E, 2 * I, H), generator=g, device="cuda") * 0.02
    w2 = torch.randn((E, H, I), generator=g, device="cuda") * 0.02
    return w13, w2


def routing(t: int, seed: int, experts: int = E):
    """Rows x (t, H) and, per row, K distinct experts among the first
    `experts` with softmax-like weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((t, H), generator=g, device="cuda")
    scores = torch.rand((t, experts), generator=g, device="cuda")
    weights, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return x, ids[:, :K].to(torch.int32).contiguous(), (weights[:, :K] / experts).contiguous()


def close(got, want):
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 10])
def test_k3_decode_reads_the_routed_experts(stack, t):
    """A decode step's rows (one, or a few beams: up to ``GEMV_PAIRS`` pairs)."""
    x, ids, w = routing(t, seed=t)
    before = moe.launches
    got = moe.experts(x, ids, w, *stack)
    torch.cuda.synchronize()
    assert moe.launches == before + 1
    close(got, moe.experts_reference(x, ids, w, *stack))


@pytest.mark.cuda
def test_k3_prefill_of_512_rows(stack):
    x, ids, w = routing(512, seed=11)
    close(moe.experts(x, ids, w, *stack), moe.experts_reference(x, ids, w, *stack))


@pytest.mark.cuda
def test_k3_prefill_where_every_row_routes_alike(stack):
    """512 rows on the same six experts: 8 full tiles each, 58 experts idle."""
    x, _, w = routing(512, seed=12)
    ids = torch.arange(K, dtype=torch.int32, device="cuda").repeat(512, 1).contiguous()
    close(moe.experts(x, ids, w, *stack), moe.experts_reference(x, ids, w, *stack))


@pytest.mark.cuda
def test_k3_prefill_where_some_experts_get_nothing_and_pads_route_nowhere(stack):
    """Rows routed among the first 16 experts only, a ragged count of rows
    (not a multiple of the tile), and the first 37 rows routed nowhere (id
    E, a prefill's pads): those rows read 0."""
    x, ids, w = routing(333, seed=13, experts=16)
    ids[:37] = E
    got = moe.experts(x, ids, w, *stack)
    close(got, moe.experts_reference(x, ids, w, *stack))
    assert float(got[:37].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 512])
def test_k3_replays_in_a_graph_with_new_routing(stack, t):
    """Captured once, replayed after the routing (ids, weights) and the rows
    changed in their static buffers: every decision is read on the device."""
    x, ids, w = routing(t, seed=20)
    out = moe.experts(x, ids, w, *stack)  # the warm run builds the kernel and the allocator's blocks
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.experts(x, ids, w, *stack)
    for seed in (21, 22, 23):
        x2, ids2, w2_ = routing(t, seed=seed, experts=E if seed != 22 else 8)
        x.copy_(x2)
        ids.copy_(ids2)
        w.copy_(w2_)
        graph.replay()
        torch.cuda.synchronize()
        close(out, moe.experts_reference(x, ids, w, *stack))


LITE = dict(vocab_size=102400, hidden_size=2048, intermediate_size=10944, num_hidden_layers=3, num_attention_heads=16,
            num_key_value_heads=16, kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128, first_k_dense_replace=1, moe_layer_freq=1, n_routed_experts=64, n_shared_experts=2,
            num_experts_per_tok=6, moe_intermediate_size=1408, topk_method="greedy", scoring_func="softmax",
            norm_topk_prob=False, routed_scaling_factor=1.0, n_group=1, topk_group=1, rms_norm_eps=1e-6,
            rope_theta=10000, max_position_embeddings=163840, attention_bias=False, hidden_act="silu",
            tie_word_embeddings=False, bos_token_id=100000, eos_token_id=100001,
            rope_scaling={"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                          "original_max_position_embeddings": 4096, "type": "yarn"})


class _Tok:
    pad_token_id, eos_token_id, chat_template = 0, 100001, None


@pytest.mark.cuda
def test_deepseek_v2_lite_layers_decode_through_graphs_on_the_card(stack):
    """DeepSeek-V2-Lite's published widths at 3 layers (the dense one and two
    of experts), random f32 weights: a greedy and a sampled reply through
    the captured prefill and steps (K3 inside them) against the plain
    reference's full forward, each step's logits within 1e-4 of the row's
    largest (three layers of f32 sums in other orders, the absorbed
    attention among them); then replayed once more and equal to the bit."""
    import os

    import numpy as np

    os.environ.update(USE_TORCH="1", USE_TF="0", USE_FLAX="0")
    from benchmark.reference import deepseek_v2 as ref
    from benchmark.weights import draw
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, import_transformers

    tf = import_transformers()
    with torch.device("cuda"):
        model = tf.DeepseekV2ForCausalLM(tf.DeepseekV2Config(**LITE)).float().eval()
    params = dict(model.named_parameters())
    draw(ref.spec(LITE), 5, "cuda", out=params)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, 100000, (200,), generator=g).numpy()
    ids = np.zeros((1, 256), np.int32)
    mask = np.zeros((1, 256), np.int32)
    ids[0, 56:], mask[0, 56:] = prompt, 1
    for temperature in (0.0, 0.6):
        lm = TorchChatLM(model=model, tokenizer=_Tok(), temperature=temperature, max_new_tokens=8, seed=4,
                         prompt_buckets=(256,), device="cuda")
        assert lm.decode == "graphs"
        runs = []
        for _ in range(2):
            gen = None if not temperature else torch.Generator(device="cuda").manual_seed(9)
            out = []
            seq = lm._generate(ids, mask, gen, logits_out=out)
            runs.append((seq, torch.cat(out)))
        assert np.array_equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
        seq, got = runs[0]
        new = [int(t) for t in seq[0, 256:]]
        want = ref.logits(sd, LITE, prompt.tolist() + new[:-1], first=len(prompt) - 1)[: got.shape[0]]
        err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max()
        assert float(err) <= 1e-4, float(err)
        assert lm.stats()["moe_pairs_sum"] > 0
