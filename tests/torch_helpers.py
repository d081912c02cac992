"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py):
reads made from a numpy seed, encoded and packed for both packages. Imports
no JAX and nothing of commet_tpu at import time (the card-only tests use it
on a machine without them): read sets are the port's, or commet_tpu's for an
engine of commet_tpu."""

import os

import numpy as np

from commet_tpu_torch.io import reads as port_reads
from commet_tpu_torch.io.reads import CODE_LUT

U32 = 0xFFFFFFFF
LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
BASES = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def random_seqs(rng, n, lmin, lmax, n_frac=0.05):
    """n reads of lengths lmin..lmax over ACGTN (both cases), N at n_frac."""
    probs = np.full(10, (1 - n_frac) / 8)
    probs[4] = probs[9] = n_frac / 2
    return [bytes(rng.choice(BASES, size=int(rng.integers(lmin, lmax + 1)),
                             p=probs))
            for _ in range(n)]


def implant(rng, idx_seqs, qry_seqs, k, span=1, start=0):
    """Copy a span*k fragment of a random index read (reverse-complemented
    half of the time) into every other query read from ``start``."""
    for i in range(start, len(qry_seqs), 2):
        donor = idx_seqs[int(rng.integers(len(idx_seqs)))]
        n = span * k
        if len(donor) < n or len(qry_seqs[i]) < n:
            continue
        at = int(rng.integers(0, len(donor) - n + 1))
        frag = donor[at:at + n]
        if rng.random() < 0.5:
            frag = frag.translate(COMP)[::-1]
        q = qry_seqs[i]
        pos = int(rng.integers(0, len(q) - n + 1))
        qry_seqs[i] = q[:pos] + frag + q[pos + n:]


def encode(seqs, lpad=None):
    """[n, lpad] uint8 codes (A=0 C=1 G=2 T=3, 4 = invalid or padding)."""
    if lpad is None:
        lpad = max(len(s) for s in seqs)
    out = np.full((len(seqs), lpad), 4, dtype=np.uint8)
    for i, s in enumerate(seqs):
        arr = CODE_LUT[np.frombuffer(s, dtype=np.uint8)][:lpad]
        out[i, :len(arr)] = arr
    return out


def write_fasta(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">r%d\n%s\n" % (i, s))


def index_pairs(rng, k, n):
    """Index pairs with equal-keya runs, exact duplicates and (k=32) the
    all-G/T key; for k > 32 keya values that share their low word."""
    top = 1 << k
    pool = rng.integers(0, top, 400, dtype=np.int64)
    if k == 32:
        pool[:3] = U32  # all-G/T keya
    if k > 32:
        pool[200:260] = (pool[:60] & U32) | (((pool[:60] >> 32) + 1) % (
            1 << (k - 32))) << 32
    a = rng.choice(pool, n)
    b = rng.integers(0, top, n, dtype=np.int64)
    b[:3] = top - 1
    a = np.concatenate([a, a[:300]])
    b = np.concatenate([b, b[:300]])  # exact duplicates
    return a, b


def query_pairs(rng, k, a, b, m):
    """Exact index pairs, index keya with another keyb, and fresh keya
    (for k > 32 some with an index key's low word but other hi bits)."""
    top = 1 << k
    pick = rng.integers(0, len(a), m)
    qa, qb = a[pick].copy(), b[pick].copy()
    third = m // 3
    qb[third:2 * third] = rng.integers(0, top, third)
    qa[2 * third:] = rng.integers(0, top, m - 2 * third)
    if k > 32:
        sl = slice(2 * third, 2 * third + third // 2)
        qa[sl] = (a[pick[sl]] & U32) | (
            (((a[pick[sl]] >> 32) + 1) % (1 << (k - 32))) << 32)
    return qa, qb


def make_fastas(tmp_path, seed, k, n_frac, n_idx=120, n_qry=150,
                length=90, n_queries=1):
    """An index fasta and query fastas whose every other read holds a 2k
    fragment of an index read (shared at t=2)."""
    rng = np.random.default_rng(seed)
    idx = random_seqs(rng, n_idx, length - 25, length, n_frac=n_frac)
    write_fasta(tmp_path / "idx.fa", idx)
    paths = []
    for qi in range(n_queries):
        qry = random_seqs(rng, n_qry, length - 25, length, n_frac=n_frac)
        implant(rng, idx, qry, k, span=2)
        paths.append(str(tmp_path / f"qry{qi}.fa"))
        write_fasta(paths[-1], qry)
    return str(tmp_path / "idx.fa"), paths, idx


def reads_module(engine=None):
    """The read-set module for ``engine``: commet_tpu's for an engine of
    commet_tpu, else the port's."""
    if type(engine).__module__.startswith("commet_tpu."):
        from commet_tpu.io import reads
        return reads
    return port_reads


def run_engine(engine, idx_fa, qry_fas, out):
    """Index set "I" against query sets "Q<i>" through ``engine``; returns
    its counters and the result .bv bytes and .log counter lines."""
    os.makedirs(out, exist_ok=True)
    rs_i = read_set("I", idx_fa, engine=engine)
    queries = [read_set(f"Q{qi}", path, engine=engine)
               for qi, path in enumerate(qry_fas)]
    counters = engine.index_and_search(rs_i, queries, out_dir=out,
                                       log_dir=out)
    return counters, outputs(out, qry_fas)


def run_amortized(engine, idx_fa, qry_fas, out, planes=True):
    """Index set "I" made resident through ``engine``
    (build_resident_planes, or build_resident) and query sets "Q<i>"
    searched against it one by one (search_multi_set_planes, or
    search_multi_set); returns the outputs run_engine returns."""
    os.makedirs(out, exist_ok=True)
    build, search = ((engine.build_resident_planes,
                      engine.search_multi_set_planes) if planes
                     else (engine.build_resident, engine.search_multi_set))
    resident = build(read_set("I", idx_fa, engine=engine))
    for qi, path in enumerate(qry_fas):
        search(read_set(f"Q{qi}", path, engine=engine), [resident],
               out_dir=out, log_dir=out)
    return outputs(out, qry_fas)


def outputs(out, qry_fas):
    """The result .bv bytes and .log counter lines that query sets "Q<i>"
    of ``qry_fas`` against index set "I" wrote into ``out``."""
    blobs = {}
    for qi, path in enumerate(qry_fas):
        with open(os.path.join(out, os.path.basename(path) + "_in_I.bv"),
                  "rb") as f:
            blobs[path] = f.read()
        with open(os.path.join(out, f"Q{qi}_in_I.log")) as f:
            blobs[f"Q{qi}.log"] = f.read().splitlines()[-1]
    return blobs


def force_jax_stream(monkeypatch):
    """commet_tpu's stream probe forced on (the Pallas join in interpret
    mode on the CPU), with its self-check cache emptied."""
    import commet_tpu.engine.engine as jengine
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    monkeypatch.setattr(jengine, "_STREAM_SELFCHECK", {})


def read_set(name, *paths, engine=None):
    """A read set of ``paths`` for ``engine`` (reads_module)."""
    rs = reads_module(engine).ReadSet(name)
    for p in paths:
        rs.add_file(p)
    return rs


def file_bytes(paths):
    """{basename: bytes} of the files."""
    out = {}
    for p in sorted(paths):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def last_line(path):
    with open(path) as f:
        return f.read().splitlines()[-1]


def long_seq(rng, n):
    """n random ACGT bases."""
    return bytes(LUT[rng.integers(0, 4, n)])


def multi_sets(tmp_path, seed, k, n_sets=3, n_idx=50, n_qry=120):
    """Index fastas idx0.fa ..; a query fasta whose reads hold 2k fragments
    of the first set (even reads) and of the last set (odd reads)."""
    rng = np.random.default_rng(seed)
    idx = []
    paths = []
    for s in range(n_sets):
        seqs = random_seqs(rng, n_idx, 60, 90, n_frac=0.01)
        idx.append(seqs)
        paths.append(str(tmp_path / f"idx{s}.fa"))
        write_fasta(paths[-1], seqs)
    qry = random_seqs(rng, n_qry, 60, 90, n_frac=0.01)
    implant(rng, idx[0], qry, k, span=2)
    implant(rng, idx[-1], qry, k, span=2, start=1)
    qpath = str(tmp_path / "qry.fa")
    write_fasta(qpath, qry)
    return paths, qpath
