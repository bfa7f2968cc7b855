"""An answer altered where it is produced: map.pipeline.map_batch moves
each hit one base along the reference."""


def install(args: dict):
    from winnowmap_tpu_torch.map import pipeline
    base = pipeline.map_batch

    def map_batch(mi, opt, seqs, qnames, **kw):
        res = base(mi, opt, seqs, qnames, **kw)
        for r in res:
            for reg in r.regs:
                reg.rs += 1
                reg.re += 1
        return res

    pipeline.map_batch = map_batch

    def undo():
        pipeline.map_batch = base
    return undo
