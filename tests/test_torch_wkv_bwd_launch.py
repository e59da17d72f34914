"""What K3b's wrapper decides in Python, on the CPU.

``rwkv_wkv.wkv_bwd`` launches one block a (batch, head) at the head dims
the CUDA source builds, and sizes the checkpoints of the state it keeps
in device memory by ``SEGMENT``, which must be the source's ``kSeg``.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import re

import pytest
import torch

from repro_torch.kernels import rwkv_wkv as kw

SOURCE = kw.KERNEL_BWD.library.source


@pytest.mark.parametrize("d", [16, 32, 64])
def test_checkpoint_shape_at_each_built_head_dim(d):
    assert d in kw.HEAD_DIMS_BWD
    assert kw.checkpoint_shape((2, 3 * kw.SEGMENT, 5, d)) == (10, 2, d, d)


def test_segment_is_the_source_default():
    found = re.findall(r"constexpr int kSeg = (\d+);", SOURCE.read_text())
    assert [int(x) for x in found] == [kw.SEGMENT] and kw.SEGMENT >= 2


@pytest.mark.parametrize("t,segments", [
    (1, 1), (kw.SEGMENT - 1, 1), (kw.SEGMENT, 1), (kw.SEGMENT + 1, 2),
    (1024, -(-1024 // kw.SEGMENT)),
])
def test_checkpoint_shape_keeps_every_segment_start_but_the_last(t, segments):
    assert kw.checkpoint_shape((8, t, 32, 64)) == (8 * 32, segments - 1,
                                                   64, 64)


def test_wkv_bwd_raises_on_a_head_dim_not_built():
    b, t, h, d = 1, 5, 2, 128
    gen = torch.Generator().manual_seed(0)
    mk = lambda *shape: torch.randn(*shape, generator=gen)
    before = kw.KERNEL_BWD.launches
    with pytest.raises(ValueError, match="no kernel built for head dim 128"):
        kw.wkv_bwd(mk(b, t, h, d), mk(b, t, h, d), mk(b, t, h, d),
                   mk(b, t, h, d), mk(h, d), mk(b, h, d, d), mk(b, t, h, d))
    with pytest.raises(ValueError, match="no kernel built"):
        kw.checkpoint_shape((b, t, h, d))
    assert kw.KERNEL_BWD.launches == before
