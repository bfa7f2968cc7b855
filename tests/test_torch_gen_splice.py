"""map_batch_generator against the port's native-engine path under
-x splice on the first reads of the splice corpus, device="cpu": regions
equal field for field, N ops and trans_strand included (the generator
path's K3 jobs without junction bytes)."""
import torch
from test_torch_engine import assert_same_results, splice_setup

torch.set_num_threads(1)


def test_generator_matches_engine_splice():
    from winnowmap_tpu_torch.map.batch import STATS, map_batch_generator
    from winnowmap_tpu_torch.map.engine import map_batch_engine

    mi, mo, seqs, names = splice_setup("splice", jax=False)
    seqs, names = seqs[:8], names[:8]
    ref = map_batch_engine(mi, mo, seqs, names, torch.device("cpu"))
    STATS.clear()
    got = map_batch_generator(mi, mo, seqs, names, device="cpu")
    assert_same_results(ref, got)
    assert STATS["dev_jobs"] > 0 and STATS["host_jobs"] == 0
    assert any(((r.p.cigar & 15) == 3).any() for x in got for r in x.regs
               if r.p is not None)
