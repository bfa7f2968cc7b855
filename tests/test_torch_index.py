"""The port's index against the JAX package's: build_index on t_ref.fa gives
the same arrays, and convert.index_from_arrays carries a JAX-built index
across so that mapping with it gives the JAX engine's results."""
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_engine import (N_READS, assert_same_results, jax_reference,
                               port_setup)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"


def _jax_index(bloom=False):
    from winnowmap_tpu.index.build import (build_index, load_weight_bloom,
                                           load_weight_set)
    from winnowmap_tpu.io.fastx import read_all

    rep = str(GOLD / "t_rep_k15.txt")
    wb = load_weight_bloom(rep, 15) if bloom else None
    ws = np.zeros(0, np.uint64) if bloom else load_weight_set(rep, 15)
    return build_index(read_all(str(GOLD / "t_ref.fa")), 10, 15, 0, ws,
                       weight_bloom=wb)


def _port_index(bloom=False):
    from winnowmap_tpu_torch.index.build import (build_index,
                                                 load_weight_bloom,
                                                 load_weight_set)
    from winnowmap_tpu_torch.io.fastx import read_all

    rep = str(GOLD / "t_rep_k15.txt")
    wb = load_weight_bloom(rep, 15) if bloom else None
    ws = np.zeros(0, np.uint64) if bloom else load_weight_set(rep, 15)
    return build_index(read_all(str(GOLD / "t_ref.fa")), 10, 15, 0, ws,
                       weight_bloom=wb)


def _arrays(mi):
    return {
        "keys": np.asarray(mi.keys), "start": np.asarray(mi.start),
        "pos": np.asarray(mi.pos), "codes": np.asarray(mi.codes),
        "seq_names": [s.name for s in mi.seqs],
        "seq_offsets": np.array([s.offset for s in mi.seqs], np.int64),
        "seq_lengths": np.array([s.length for s in mi.seqs], np.int64),
        "wset": np.asarray(mi.wset), "bloom": mi.bloom,
        "w": mi.w, "k": mi.k, "flag": mi.flag,
    }


@pytest.mark.parametrize("bloom", [False, True], ids=["set", "bloom"])
def test_build_index_matches_jax(bloom):
    a, b = _jax_index(bloom), _port_index(bloom)
    for f in ("keys", "start", "pos", "codes", "wset"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert [(s.name, s.offset, s.length) for s in a.seqs] == \
        [(s.name, s.offset, s.length) for s in b.seqs]
    assert a.stat_line() == b.stat_line()
    assert a.cal_max_occ(2e-4) == b.cal_max_occ(2e-4)


def test_index_from_arrays_roundtrip():
    from winnowmap_tpu_torch.convert import index_from_arrays

    a = _jax_index()
    b = index_from_arrays(_arrays(a))
    for f in ("keys", "start", "pos", "codes", "wset"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (b.w, b.k, b.flag, b.bloom) == (a.w, a.k, a.flag, None)
    assert b.getseq(0, 5, 25).tolist() == a.getseq(0, 5, 25).tolist()
    bad = _arrays(a)
    bad["start"] = bad["start"][:-1]
    with pytest.raises(ValueError, match="start"):
        index_from_arrays(bad)


@pytest.mark.parametrize("sv_aware", [True, False], ids=["sv", "svoff"])
def test_converted_index_maps_like_jax(sv_aware, monkeypatch):
    """The JAX package's golden index, carried across, maps the first
    N_READS golden reads exactly as the JAX engine does."""
    from winnowmap_tpu_torch.convert import index_from_arrays
    from winnowmap_tpu_torch.map.batch import map_batch
    from winnowmap_tpu_torch.options import update_mid_occ

    ref, seqs, names = jax_reference(sv_aware, monkeypatch)
    from test_torch_engine import jax_setup

    jmi = jax_setup(sv_aware)[0]
    mi = index_from_arrays(_arrays(jmi))
    _, mo = port_setup(sv_aware)
    update_mid_occ(mo, mi)
    got = map_batch(mi, mo, seqs[:N_READS], names[:N_READS], device="cpu")
    assert_same_results(ref, got)
