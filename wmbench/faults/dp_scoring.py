"""The extension DP run under another scoring than the one stated: each
map.engine.DevCallPooled call (K1, K3, K4 and their tracebacks) gets the
gap costs in `args` (any of q, e, q2, e2) in place of the engine's.  The
engine's host work, which scores the paths it gets back (ms:i), keeps the
stated scoring, so every record stays consistent with itself."""


def install(args: dict):
    from winnowmap_tpu_torch.map import engine
    base = engine.DevCallPooled
    names = ("q", "e", "q2", "e2")
    bad = set(args) - set(names)
    if bad:
        raise KeyError(f"dp_scoring changes only {names}, not {sorted(bad)}")

    class DevCallPooled(base):
        def __init__(self, pools, jobs, mat, q, e, q2, e2, *rest, **kw):
            sc = dict(zip(names, (q, e, q2, e2)), **args)
            super().__init__(pools, jobs, mat, sc["q"], sc["e"], sc["q2"],
                             sc["e2"], *rest, **kw)

    engine.DevCallPooled = DevCallPooled

    def undo():
        engine.DevCallPooled = base
    return undo
