"""gcslam_torch on the card: the CUDA Sinkhorn kernel against its plain
PyTorch loop, and the scan step on CUDA against the same step on the CPU.
Marked `cuda`; skips where torch.cuda.is_available() is false. This file
imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.ops import sinkhorn

pytestmark = pytest.mark.cuda

ARGS = (0.05, 1.0, 1.0, 50)
# f32: the Pallas test's tolerance (other summation orders); f64: 1e-10
TOL = {torch.float32: dict(rtol=2e-5, atol=1e-7), torch.float64: dict(rtol=1e-10, atol=1e-30)}
SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128,
             surfel_voxel_size_m=0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(B, N, K, seed):
    rng = np.random.default_rng(seed)
    shape = (N,) if B is None else (B, N)
    C = rng.uniform(0.0, 5.0, size=shape + (K,))
    valid = rng.uniform(size=shape) > 0.33
    a = valid / np.maximum(valid.sum(-1, keepdims=True), 1e-9)
    return C, a, np.full(shape[:-1] + (K,), 1.0 / K), ~valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,N,K", [(None, 1024, 8), (4, 1024, 8), (None, 1536, 8), (None, 257, 8),
                                   (2, 100, 20)])
def test_kernel_matches_plain(cuda, dtype, B, N, K):
    C, a, b, zero = _case(B, N, K, seed=N + K)
    t = [torch.as_tensor(x, dtype=dtype, device=cuda) for x in (C, a, b)]
    before = sinkhorn.COUNTER.launches
    out = sinkhorn.sinkhorn_unbalanced(*t, *ARGS)
    ref = sinkhorn.sinkhorn_unbalanced_reference(*t, *ARGS)
    torch.cuda.synchronize()
    assert sinkhorn.COUNTER.launches == before + 1
    torch.testing.assert_close(out, ref, **TOL[dtype])
    assert torch.all(out[torch.as_tensor(zero, device=cuda)] == 0)


def test_kernel_refuses_cpu_and_oversized_inputs(cuda):
    C, a, b, _ = _case(None, 64, 8, seed=0)
    t = [torch.as_tensor(x, device=cuda) for x in (C, a, b)]
    with pytest.raises(ValueError):
        sinkhorn.sinkhorn_unbalanced(t[0], t[1].cpu(), t[2], *ARGS)
    big = torch.zeros(64, 40, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        sinkhorn.sinkhorn_unbalanced(big, t[1], torch.full((40,), 0.025, dtype=torch.float64, device=cuda),
                                     *ARGS)


def test_run_bag_on_cuda_matches_cpu(cuda):
    """The same 5 scans on the card and on the CPU: the kernel and the plain
    loop, and cuBLAS and CPU reductions, sum in other orders (rtol 1e-10 per
    call); poses agree to a few micrometres."""
    batches = generate(SyntheticConfig(n_scans=5, n_points=512)).batches
    cfg = PipelineConfig(**SMALL)
    _, cpu = runner.run_bag(batches, cfg, device="cpu")
    before = sinkhorn.COUNTER.launches
    _, gpu = runner.run_bag(batches, cfg, device=cuda)
    assert sinkhorn.COUNTER.launches - before == cfg.map_icp_iters * 5
    np.testing.assert_allclose(gpu.pose.cpu().numpy(), cpu.pose.numpy(), rtol=0, atol=1e-5)
