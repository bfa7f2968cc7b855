"""The port's map_batch (native engine + every exported DP job through the
plain PyTorch versions of its kernels, device="cpu") against the JAX
package's map_batch_engine on its host kernels (WM_NO_TPU=1), on the first
N_READS golden reads, SV-aware on and off: the regions must be equal field
for field (tests/test_engine.py's _reg_key) and the DP jobs must have gone
through the port's device path."""
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"
N_READS = 8


def reg_key(r):
    return (r.id, r.cnt, r.rid, r.score, r.qs, r.qe, r.rs, r.re, r.parent,
            r.subsc, r.mlen, r.blen, r.n_sub, r.score0, r.mapq, r.inv, r.rev,
            r.split, r.sam_pri, r.hash, r.div,
            None if r.p is None else (r.p.dp_score, r.p.dp_max, r.p.dp_max2,
                                      r.p.n_ambi, r.p.trans_strand,
                                      tuple(r.p.cigar.tolist())))


def assert_same_results(ref, got):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert [reg_key(r) for r in a.regs] == [reg_key(r) for r in b.regs], i
        assert (a.rep_len, a.frag_gap, a.rep_len_defined) == \
            (b.rep_len, b.frag_gap, b.rep_len_defined), i


def jax_setup(sv_aware):
    from winnowmap_tpu.index.build import build_index, load_weight_set
    from winnowmap_tpu.io.fastx import read_all
    from winnowmap_tpu.options import (MM_F_CIGAR, MM_F_OUT_SAM,
                                       IndexOptions, MapOptions,
                                       update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR | MM_F_OUT_SAM
    mo.sv_aware = sv_aware
    wset = load_weight_set(str(GOLD / "t_rep_k15.txt"), io_.k)
    mi = build_index(read_all(str(GOLD / "t_ref.fa")), io_.w, io_.k,
                     io_.flag, wset)
    update_mid_occ(mo, mi)
    reads = read_all(str(GOLD / "t_reads.fa"))[:N_READS]
    return mi, mo, [r.seq for r in reads], [r.name for r in reads]


def port_setup(sv_aware):
    from winnowmap_tpu_torch.index.build import build_index, load_weight_set
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, MM_F_OUT_SAM,
                                             IndexOptions, MapOptions,
                                             update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR | MM_F_OUT_SAM
    mo.sv_aware = sv_aware
    wset = load_weight_set(str(GOLD / "t_rep_k15.txt"), io_.k)
    mi = build_index(read_all(str(GOLD / "t_ref.fa")), io_.w, io_.k,
                     io_.flag, wset)
    update_mid_occ(mo, mi)
    return mi, mo


def jax_reference(sv_aware, monkeypatch):
    monkeypatch.setenv("WM_NO_TPU", "1")
    from winnowmap_tpu.map.engine import map_batch_engine

    mi, mo, seqs, names = jax_setup(sv_aware)
    return map_batch_engine(mi, mo, seqs, names), seqs, names


@pytest.mark.parametrize("sv_aware", [True, False], ids=["sv", "svoff"])
def test_map_batch_matches_jax_engine(sv_aware, monkeypatch):
    from winnowmap_tpu_torch.map.batch import STATS, map_batch

    ref, seqs, names = jax_reference(sv_aware, monkeypatch)
    mi, mo = port_setup(sv_aware)
    STATS.clear()
    got = map_batch(mi, mo, seqs, names, device="cpu")
    assert_same_results(ref, got)
    assert STATS["dev_jobs"] > 0
    assert STATS["delivered_jobs"] == STATS["dev_jobs"]
    assert STATS["dev_calls"] > 0


def test_map_batch_unported_options_raise():
    """--sr raises; single-cost profiles and spliced mapping run, but not
    spliced mapping with junction annotations (--junc-bed), whose path is
    not ported."""
    from winnowmap_tpu_torch.map.batch import map_batch
    from winnowmap_tpu_torch.options import MM_F_SPLICE, MM_F_SR

    mi, mo = port_setup(True)
    for flag in (MM_F_SR,):
        with pytest.raises(NotImplementedError):
            map_batch(mi, replace(mo, flag=mo.flag | flag), [b"ACGT" * 50],
                      ["r"], device="cpu")
    assert len(map_batch(mi, replace(mo, q2=mo.q, e2=mo.e), [b"ACGT" * 50],
                         ["r"], device="cpu")) == 1
    spliced = replace(mo, flag=mo.flag | MM_F_SPLICE)
    assert len(map_batch(mi, spliced, [b"ACGT" * 50], ["r"],
                         device="cpu")) == 1
    mi.intervals = {0: np.zeros((1, 2), np.int64)}
    with pytest.raises(NotImplementedError, match="junc-bed"):
        map_batch(mi, spliced, [b"ACGT" * 50], ["r"], device="cpu")


def test_map_batch_default_device_is_cuda():
    from winnowmap_tpu_torch.map.batch import map_batch

    if torch.cuda.is_available():
        pytest.skip("a card is present; the CUDA path is tested in "
                    "test_torch_gpu.py")
    mi, mo = port_setup(False)
    with pytest.raises(RuntimeError, match="CUDA"):
        map_batch(mi, mo, [b"ACGT" * 50], ["r"])


def test_read_pool_layout():
    from winnowmap_tpu_torch.io.seqcode import encode
    from winnowmap_tpu_torch.map.engine import build_read_pool

    seqs = [b"ACGTN", b"GGA"]
    pool, offs = build_read_pool(seqs)
    fwd0 = encode(seqs[0])
    assert offs == [(0, 5), (10, 13)]
    assert np.array_equal(pool[0:5], fwd0)
    rc = fwd0[::-1]
    assert np.array_equal(pool[5:10], np.where(rc < 4, 3 - rc, rc))


def splice_setup(preset, jax: bool):
    """The splice corpus (s_ref.fa, s_reads.fa) under a splice preset, with
    the JAX package's modules or the port's."""
    if jax:
        from winnowmap_tpu.index.build import build_index, load_weight_set
        from winnowmap_tpu.io.fastx import read_all
        from winnowmap_tpu.options import (MM_F_CIGAR, IndexOptions,
                                           MapOptions, set_preset,
                                           update_mid_occ)
    else:
        from winnowmap_tpu_torch.index.build import (build_index,
                                                     load_weight_set)
        from winnowmap_tpu_torch.io.fastx import read_all
        from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                                 MapOptions, set_preset,
                                                 update_mid_occ)
    io_, mo = IndexOptions(), MapOptions()
    set_preset(preset, io_, mo)
    mo.flag |= MM_F_CIGAR
    wset = load_weight_set(str(GOLD / "s_rep_k15.txt"), io_.k)
    mi = build_index(read_all(str(GOLD / "s_ref.fa")), io_.w, io_.k,
                     io_.flag, wset)
    update_mid_occ(mo, mi)
    reads = read_all(str(GOLD / "s_reads.fa"))
    return mi, mo, [r.seq for r in reads], [r.name for r in reads]


@pytest.mark.parametrize("preset", ["splice", "splice:hq"])
def test_splice_map_batch_matches_jax_engine(preset, monkeypatch):
    """Spliced mapping of the whole splice corpus: every region, its
    trans_strand and its CIGAR (N ops included) equal the JAX engine's, and
    every DP job went through the exts path (no extd launch)."""
    from winnowmap_tpu_torch.map.batch import STATS, map_batch

    monkeypatch.setenv("WM_NO_TPU", "1")
    from winnowmap_tpu.map.engine import map_batch_engine

    jmi, jmo, seqs, names = splice_setup(preset, jax=True)
    ref = map_batch_engine(jmi, jmo, seqs, names)
    mi, mo, _, _ = splice_setup(preset, jax=False)
    STATS.clear()
    got = map_batch(mi, mo, seqs, names, device="cpu")
    assert_same_results(ref, got)
    assert STATS["delivered_jobs"] == STATS["dev_jobs"] > 0
    assert STATS["eng_host_dp_calls"] == 0
    n_spliced = sum(any(((r.p.cigar & 15) == 3).any() for r in x.regs
                        if r.p is not None) for x in got)
    assert n_spliced >= len(seqs) // 2
    assert {r.p.trans_strand for x in got for r in x.regs} >= {1, 2}


def test_converted_splice_index_maps_like_jax(monkeypatch):
    """The JAX package's splice index (w = 25), carried across with
    convert.index_from_arrays, maps the splice corpus as the JAX engine
    does."""
    from test_torch_index import _arrays
    from winnowmap_tpu_torch.convert import index_from_arrays
    from winnowmap_tpu_torch.map.batch import map_batch
    from winnowmap_tpu_torch.options import update_mid_occ

    monkeypatch.setenv("WM_NO_TPU", "1")
    from winnowmap_tpu.map.engine import map_batch_engine

    jmi, jmo, seqs, names = splice_setup("splice", jax=True)
    ref = map_batch_engine(jmi, jmo, seqs, names)
    mi = index_from_arrays(_arrays(jmi))
    assert mi.w == 25
    _, mo, _, _ = splice_setup("splice", jax=False)
    update_mid_occ(mo, mi)
    assert_same_results(ref, map_batch(mi, mo, seqs, names, device="cpu"))
