"""Card-only tests of the PyTorch port: the hand-written CUDA join kernel
against its plain PyTorch version, and the engine on the card against the
engine on the CPU. Each skips without a CUDA card. The file imports no JAX,
so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from commet_tpu_torch.core import stream as tstream
from commet_tpu_torch.engine import engine as tengine
from torch_helpers import index_pairs, make_fastas, query_pairs, run_engine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the join kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [15, 32, 33])
def test_join_kernel_matches_plain_on_card(cuda_device, k):
    """The kernel (csrc/join.cu) against join_membership_plain on the card:
    sorted and unsorted queries, the full index, a prefix and an empty one,
    long equal-keya runs. Verdicts are integers: exact equality."""
    rng = np.random.default_rng(80 + k)
    a, b = index_pairs(rng, k, 200_000)
    qa, qb = query_pairs(rng, k, a, b, 300_000)
    sidx = tstream.finalize_index([torch.from_numpy(a).to(cuda_device)],
                                  [torch.from_numpy(b).to(cuda_device)])
    qa_t = torch.from_numpy(qa).to(cuda_device)
    qb_t = torch.from_numpy(qb).to(cuda_device)
    order = torch.argsort(qa_t)
    for mi in (sidx.mi, sidx.mi // 3, 0):
        for x, y in ((qa_t, qb_t), (qa_t[order], qb_t[order])):
            before = tstream.join_membership.launches
            got = tstream.join_membership(sidx.ika, sidx.ikb, mi, x, y)
            torch.cuda.synchronize()
            assert tstream.join_membership.launches == before + 1
            want = tstream.join_membership_plain(sidx.ika, sidx.ikb, mi, x, y)
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_join_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        tstream.join_membership(x, x, 9, x, x)  # mi past the index
    with pytest.raises(ValueError):
        tstream.join_membership(x.to(torch.int32), x, 8, x, x)
    with pytest.raises(ValueError):
        tstream.join_membership(x, x, 8, x.cpu(), x)


@pytest.mark.gpu
def test_engine_cuda_matches_cpu(tmp_path, monkeypatch, cuda_device):
    """The same sets through Engine(device="cuda") (join kernel, pinned
    non-blocking uploads, several prefetched batches) and
    Engine(device="cpu") (plain version): identical bytes and counters."""
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 909, 21, 0.02, n_queries=2)
    monkeypatch.setattr(tengine, "STREAM_BATCH", 64)
    before = tstream.join_membership.launches
    _c, got = run_engine(tengine.Engine(k=21, t=2, device=cuda_device),
                         idx_fa, qry_fas, str(tmp_path / "cuda"))
    assert tstream.join_membership.launches > before
    _c, want = run_engine(tengine.Engine(k=21, t=2, device="cpu"), idx_fa,
                          qry_fas, str(tmp_path / "cpu"))
    assert got == want
