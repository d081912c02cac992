"""Guards of the PyTorch port: it never imports JAX, a CUDA request without
a card fails instead of running on the CPU, and the join and plane wrappers
take their plain versions only for CPU tensors."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from commet_tpu_torch.cli import index_and_search as tias
from commet_tpu_torch.core import planes as tplanes
from commet_tpu_torch.core import stream as tstream
from commet_tpu_torch.device import resolve_device
from commet_tpu_torch.engine import engine as tengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter runs the driver on two tiny sets on the CPU and
    ends with no jax module and no module of the JAX package (commet_tpu)
    loaded (this process cannot tell: conftest imports both)."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from commet_tpu_torch.cli import commet, index_and_search  # noqa
        import commet_tpu_torch.state  # noqa
        tmp = {str(tmp_path)!r}
        for name, seq in (("a", "ACGTTGCAAGGCTTACGATCGATCGGATCCA" * 3),
                          ("b", "TTGCAAGGCTTACGATCGATCGGATCCAAC" * 3)):
            with open(f"{{tmp}}/{{name}}.fa", "w") as f:
                f.write(f">r0\\n{{seq}}\\n>r1\\nACGTACGTACGT\\n")
        with open(f"{{tmp}}/sets.txt", "w") as f:
            f.write(f"A: {{tmp}}/a.fa\\nB: {{tmp}}/b.fa\\n")
        rc = commet.main([f"{{tmp}}/sets.txt", "-k", "15", "--no-plots",
                          "-o", f"{{tmp}}/out", "--device", "cpu"])
        assert rc == 0
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib")))
        assert not loaded, loaded
        loaded = sorted(m for m in sys.modules
                        if m == "commet_tpu" or m.startswith("commet_tpu."))
        assert not loaded, loaded
        print("NO_JAX_OK")
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert os.path.exists(tmp_path / "out" / "matrix_plain.csv")


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda:0")
    (tmp_path / "i.txt").write_text(f"A: {tmp_path}/missing.fa\n")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tias.main(["-i", str(tmp_path / "i.txt"),
                   "-s", str(tmp_path / "i.txt"), "--device", "cuda"])
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_join_wrapper_takes_plain_path_on_cpu():
    before = tstream.join_membership.launches
    ika = torch.tensor([1, 1, 5, 9], dtype=torch.int64)
    ikb = torch.tensor([2, 7, 0, 3], dtype=torch.int64)
    qa = torch.tensor([1, 1, 5, 6, 9, 0], dtype=torch.int64)
    qb = torch.tensor([7, 3, 0, 0, 4, 0], dtype=torch.int64)
    got = tstream.join_membership(ika, ikb, 4, qa, qb)
    assert got.tolist() == [tstream.CONF, tstream.CAND, tstream.CONF,
                            tstream.NONMEM, tstream.CAND, tstream.NONMEM]
    assert tstream.join_membership.launches == before
    # a prefix mi hides the rest of the index
    assert tstream.join_membership(ika, ikb, 2, qa, qb).tolist() == [
        tstream.CONF, tstream.CAND] + [tstream.NONMEM] * 4
    with pytest.raises(ValueError):  # mi past the index
        tstream.join_membership(ika, ikb, 5, qa, qb)
    with pytest.raises(ValueError):
        tstream.join_membership(ika.to("meta"), ikb.to("meta"), 4,
                                qa.to("meta"), qb.to("meta"))


def test_build_memory_check_names_the_dense_plane_item(monkeypatch):
    """Before each build on the card the engine compares the partition's
    sorted-index cost with the free device memory and raises instead of
    running out halfway, naming the dense-plane route and how to take it
    (the card is faked: only the check runs)."""
    eng = tengine.Engine(k=33, t=2, device="cpu")
    eng.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (8 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 2 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 1 << 30)
    with pytest.raises(MemoryError, match="dense-plane") as exc:
        eng._check_build_memory(tengine.max_kmer_for(33))
    assert "COMMET_TPU_STREAM=0" in str(exc.value)
    assert "COMMET_TPU_STREAM_MAX_FILL" in str(exc.value)
    eng._check_build_memory((9 << 30) // tengine.BUILD_BYTES_PER_KMER)


def test_plane_wrappers_take_plain_path_on_cpu():
    """CPU tensors run the plain versions and count no launch; a wrong
    dtype, shape, plane size or device raises."""
    k = 8
    counts = (tplanes.build_planes.launches, tplanes.probe_planes.launches,
              tplanes.probe_planes_multi.launches)
    pl = tplanes.alloc_planes(k, "cpu")
    assert pl.shape == (4 * 8,) and pl.dtype == torch.int32
    # one read ACGTACGTAC (codes 0 1 2 3 ...), 2 bits each, N-free
    word = sum(((i % 4) << (2 * i)) for i in range(10))
    c2 = torch.tensor([[word]], dtype=torch.int32)
    ln = torch.tensor([10], dtype=torch.int32)
    tplanes.build_planes(pl, c2, ln, True, 16, k)
    assert int((pl != 0).sum()) > 0
    assert tplanes.probe_planes(pl, c2, ln, True, 16, k, 1).tolist() == [True]
    slots = tplanes.PlaneSlots([pl, tplanes.alloc_planes(k, "cpu")])
    assert tplanes.probe_planes_multi(slots, c2, ln, True, 16, k,
                                      1).tolist() == [[True], [False]]
    assert (tplanes.build_planes.launches, tplanes.probe_planes.launches,
            tplanes.probe_planes_multi.launches) == counts
    with pytest.raises(ValueError):  # planes of another k
        tplanes.probe_planes(pl, c2, ln, True, 16, 9, 1)
    with pytest.raises(ValueError):  # int64 words
        tplanes.build_planes(pl, c2.long(), ln, True, 16, k)
    with pytest.raises(ValueError):  # too few words for the length
        tplanes.probe_planes(pl, c2, ln, True, 17, k, 1)
    with pytest.raises(ValueError):  # validity words missing
        tplanes.probe_planes(pl, c2, ln, False, 16, k, 1)
    with pytest.raises(ValueError):  # plane sets of two sizes
        tplanes.PlaneSlots([pl, tplanes.alloc_planes(k + 1, "cpu")])
    with pytest.raises(ValueError):
        tplanes.probe_planes(pl.to("meta"), c2.to("meta"), ln.to("meta"),
                             True, 16, k, 1)
