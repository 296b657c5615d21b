"""The port's plain MAS (``maximum_path_reference``, which repeats the K2
kernel's arithmetic column by column and is what ``maximum_path`` runs on a
CPU tensor) against the JAX package's ``maximum_path`` — the ``lax.scan``
backend and the Pallas kernel in interpret mode, as ``tests/test_mas_pallas.py``
runs it on the CPU — and against the brute-force numpy oracle.

Tolerance: none.  The paths are binary and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu.ops import mas as jax_mas
from emojivoice_tpu_torch.ops import mas

torch.set_num_threads(1)


def _problem(rng, b, tx_max, ty_max, t_xs, t_ys, peaked=False):
    value = rng.normal(size=(b, tx_max, ty_max)).astype(np.float32)
    if peaked:
        for i in range(b):
            xs = np.linspace(0, t_xs[i] - 1, t_ys[i])
            for y in range(t_ys[i]):
                value[i, int(round(xs[y])), y] += 4.0
    mask = np.zeros((b, tx_max, ty_max), np.float32)
    for i in range(b):
        mask[i, : t_xs[i], : t_ys[i]] = 1.0
    return value, mask


def _ragged(seed):
    rng = np.random.default_rng(seed)
    b = 5
    t_xs = [int(v) for v in rng.integers(1, 12, size=b)]
    t_ys = [int(max(tx, v)) for tx, v in zip(t_xs, rng.integers(4, 30, size=b))]
    return _problem(rng, b, 12, 30, t_xs, t_ys)


def _peaked():
    return _problem(np.random.default_rng(11), 2, 6, 15, [6, 4], [15, 9], peaked=True)


def _over_16_items():
    rng = np.random.default_rng(12)
    t_xs = [int(v) for v in rng.integers(2, 9, size=17)]
    t_ys = [int(max(a, b)) for a, b in zip(rng.integers(8, 21, size=17), t_xs)]
    return _problem(rng, 17, 8, 20, t_xs, t_ys)


def _equal_lengths():
    return _problem(np.random.default_rng(13), 3, 7, 9, [7, 5, 3], [7, 5, 3])


def _single_token():
    return _problem(np.random.default_rng(14), 3, 5, 10, [1, 1, 1], [10, 4, 1])


CASES = {**{f"ragged{s}": (lambda s=s: _ragged(s)) for s in range(5)},
         "peaked": _peaked, "over16": _over_16_items, "equal_lengths": _equal_lengths,
         "single_token": _single_token}


def _ours(value, mask):
    got = mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and not got.requires_grad
    return got.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["jax", "pallas_interpret"])
def test_reference_equals_jax_backend(case, backend):
    value, mask = CASES[case]()
    want = np.asarray(jax_mas.maximum_path(jnp.asarray(value), jnp.asarray(mask), backend=backend))
    np.testing.assert_array_equal(_ours(value, mask), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_numpy_oracle(case):
    value, mask = CASES[case]()
    got = _ours(value, mask)
    np.testing.assert_array_equal(got, mas.maximum_path_numpy(value * mask, mask))
    np.testing.assert_array_equal(got, jax_mas.maximum_path_numpy(value * mask, mask))
    assert mas.path_faults(torch.from_numpy(got), torch.from_numpy(mask)) == []


def test_text_longer_than_mel_matches_jax():
    """t_x > t_y has no valid alignment; the kernel's contract still defines
    the answer through the x > y mask, and the port repeats it."""
    rng = np.random.default_rng(15)
    value, mask = _problem(rng, 3, 9, 6, [9, 7, 2], [4, 6, 5])
    for backend in ("jax", "pallas_interpret"):
        want = np.asarray(jax_mas.maximum_path(jnp.asarray(value), jnp.asarray(mask), backend=backend))
        np.testing.assert_array_equal(_ours(value, mask), want)


def test_empty_item_gives_empty_path():
    rng = np.random.default_rng(16)
    value, mask = _problem(rng, 2, 4, 8, [0, 3], [0, 8])
    got = _ours(value, mask)
    assert got[0].sum() == 0 and got[1].sum() == 8
    want = np.asarray(jax_mas.maximum_path(jnp.asarray(value), jnp.asarray(mask), backend="pallas_interpret"))
    np.testing.assert_array_equal(got, want)


def test_path_faults_reports_a_broken_path():
    value, mask = _peaked()
    path = torch.from_numpy(_ours(value, mask)).clone()
    path[0, :, 3] = 0
    assert mas.path_faults(path, torch.from_numpy(mask))


def test_wrapper_rejects_unknown_device():
    with pytest.raises(ValueError, match="no kernel for device"):
        mas.maximum_path(torch.zeros((1, 2, 3), device="meta"), torch.zeros((1, 2, 3), device="meta"))
