"""``PrefetchToDevice`` on the card (moved from tests/test_torch_io.py,
whose CPU tests hold the port's I/O to the JAX package's)."""

import numpy as np
import pytest
import torch

from hyperres_torch.io import pipeline as tpipeline


@pytest.mark.gpu
def test_prefetch_cuda_buffers_outlive_their_use(cuda):
    """On the card, with a consumer that keeps its stream busy before it
    reads each batch: every batch arrives intact (the pinned buffer
    outlives its copy; the side-stream tensor is record_stream'd, so the
    allocator does not hand it to a later copy)."""
    n, shape = 24, (1024, 1024)

    def source():
        for i in range(n):
            yield np.full(shape, i, np.float32)

    sums = []
    for x in tpipeline.PrefetchToDevice(source(), depth=3, device=cuda):
        torch.cuda._sleep(2_000_000)
        sums.append(x.sum())
        del x
    torch.cuda.synchronize()
    assert [float(s) for s in sums] == [float(i * shape[0] * shape[1])
                                        for i in range(n)]
