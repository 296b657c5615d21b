"""K2, the monotonic-alignment-search CUDA kernel, against its plain version
on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  Imports no JAX, so it runs
where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_mas_cuda.py -q

Tolerance: none.  The arithmetic is one f32 add and one max per cell with no
reduction, so kernel and plain version must be equal (``torch.equal``), on a
bf16 log-prior (ties common) as on an f32 one.
"""

import pytest
import torch

from chip_smoke import MAS_SHAPES, ragged_mas_problem  # the smoke's shapes and its seeded ragged problems
from emojivoice_tpu_torch.ops import mas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("K2 is a CUDA kernel: it needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_x,t_y", MAS_SHAPES)
def test_k2_equals_plain_version(cuda, b, t_x, t_y):
    value, mask = ragged_mas_problem(b, t_x, t_y, seed=t_x + t_y)
    before = mas.launches
    got = mas.maximum_path(value, mask)
    torch.cuda.synchronize()
    assert mas.launches == before + 1
    assert torch.equal(got, mas.maximum_path_reference(value, mask))
    assert mas.path_faults(got, mask) == []


@pytest.mark.cuda
@pytest.mark.parametrize("t_x", [1, 31, 33, 257, 1025, 1500])
def test_k2_text_widths_around_the_lane_blocks(cuda, t_x):
    """T_x at and beside the widths where the positions per lane change
    (1, 2, 16, 64 a lane) and beyond 1,024."""
    value, mask = ragged_mas_problem(3, t_x, t_x + 101, seed=t_x)
    got = mas.maximum_path(value, mask)
    assert torch.equal(got, mas.maximum_path_reference(value, mask))
    assert mas.path_faults(got, mask) == []


@pytest.mark.cuda
def test_k2_rejects_text_wider_than_its_registers(cuda):
    value, mask = ragged_mas_problem(1, 2049, 2050, seed=0)
    with pytest.raises(ValueError, match="2048"):
        mas.maximum_path(value, mask)


@pytest.mark.cuda
def test_k2_text_longer_than_mel_and_empty_items(cuda):
    g = torch.Generator().manual_seed(3)
    value = torch.randn((3, 40, 30), generator=g)
    mask = torch.zeros((3, 40, 30))
    mask[0, :40, :12] = 1  # t_x > t_y: defined through the x > y rule
    mask[2, :7, :30] = 1   # item 1 stays empty
    value, mask = value.cuda(), mask.cuda()
    got = mas.maximum_path(value, mask)
    assert torch.equal(got, mas.maximum_path_reference(value, mask))
    assert float(got[1].sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_x,t_y", [(16, 256, 768), (4, 512, 2048)])
def test_k2_on_a_bf16_log_prior(cuda, b, t_x, t_y):
    """Under bf16-mixed training the log-prior is bf16 (large magnitudes on a
    coarse grid: ties are common): K2 searches its f32 value and returns the
    path in bf16, equal to the plain search to the bit."""
    value, mask = ragged_mas_problem(b, t_x, t_y, seed=t_x)
    value = (value * 40 - 300).to(torch.bfloat16)
    before = mas.launches
    got = mas.maximum_path(value, mask)
    torch.cuda.synchronize()
    assert mas.launches == before + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got, mas.maximum_path_reference(value, mask))
    assert mas.path_faults(got.float(), mask) == []


@pytest.mark.cuda
def test_k2_rejects_what_it_cannot_run(cuda):
    value, mask = ragged_mas_problem(2, 8, 16, seed=0)
    # any float dtype is searched in f32, as in the JAX package; an integer value is refused
    assert torch.equal(mas.maximum_path(value.double(), mask), mas.maximum_path(value, mask).double())
    with pytest.raises(ValueError, match="float32"):
        mas.maximum_path(value.long(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        mas.maximum_path(value.transpose(1, 2).contiguous().transpose(1, 2), mask)
    with pytest.raises(ValueError, match="mask"):
        mas.maximum_path(value, mask[:, :, :8].contiguous())
