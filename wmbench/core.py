"""One run of one cell: set-up, the timed window, the check, the result.

The system under test is winnowmap_tpu_torch's file driver,
`map.pipeline.map_file`, as the CLI calls it: a configuration's preset,
index (built by the port in every run, `index.build.build_index` with
`load_weight_set` of the `-W` list) and `-a` SAM output, a batch a read
file of the mix's `-K` bases under TMPDIR, its SAM written to a file
under TMPDIR.

A cell is found by name: BENCHMARK.json's workload names its configuration
(its `file`, under wmbench/configs/) and its traffic mix
(wmbench/traffic/<mix>.json); the configuration names its genome generator
and its plain reference (modules of wmbench and wmbench/reference), the mix
its traffic generator and its controls (each fault of one is
wmbench/faults/<fault>.py); each per-layer metric is
wmbench/metrics/<name>.py.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "winnowmap_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(manifest: dict, name: str, base: Path = HERE):
    """(workload, configuration entry, configuration dict, its file, mix)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name!r}")
    w = cells[name]
    centry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfile = base.parent / centry["file"]
    cfg = json.loads(cfile.read_text())
    mix = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    return w, centry, cfg, cfile, mix


def module(name: str, package: str = "wmbench"):
    """A generator or reference module of wmbench, found by name."""
    return importlib.import_module(f"{package}.{name}")


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: Path = HERE):
    """wmbench/metrics/<name>.py's read(record), loaded by file."""
    return _load_file(base / "metrics" / f"{name}.py",
                      f"wmbench_metric_{name}").read


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_info() -> dict:
    """The host's cores as this process sees them, and its load."""
    return {"cpu_count": os.cpu_count(),
            "cores": len(os.sched_getaffinity(0)),
            "loadavg": os.getloadavg()}


def card_info() -> dict:
    """The card's name and power limit, read with nvidia-smi, and the
    host's cores and load."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return {"nvidia_smi": out, **host_info()}


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _file_digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 22):
            h.update(chunk)
    return h.hexdigest()


# the CLI flags a configuration may list, and the MapOptions flag bits each
# sets; set_options refuses any other
CLI_FLAGS = {"-a": ("MM_F_OUT_SAM", "MM_F_CIGAR")}


def _flag_bit(key: str) -> int:
    from winnowmap_tpu_torch import options
    bit = getattr(options, key, None) if key.startswith("MM_F_") else None
    if not isinstance(bit, int):
        raise KeyError(f"no map option or flag {key!r}")
    return bit


def option_value(mo, key: str):
    """A MapOptions field, or for an MM_F_* name whether mo.flag has it."""
    if key.startswith("MM_F_"):
        return bool(mo.flag & _flag_bit(key))
    if key not in type(mo).__dataclass_fields__:
        raise KeyError(f"no map option or flag {key!r}")
    return getattr(mo, key)


def set_option(mo, key: str, value) -> None:
    if key.startswith("MM_F_"):
        bit = _flag_bit(key)
        mo.flag = mo.flag | bit if value else mo.flag & ~bit
    else:
        option_value(mo, key)
        setattr(mo, key, value)


def set_options(cfg: dict, mix: dict, overrides: dict | None = None):
    """The CLI's options for the configuration: its preset, -k, -w, its
    flags (each in CLI_FLAGS), -K from the mix.  The preset has to give
    every entry of the configuration's `scoring` (MapOptions fields, or
    MM_F_* flag names).  `overrides` (a control's `options`, by the same
    names) then change what the configuration states."""
    from winnowmap_tpu_torch.options import (IndexOptions, MapOptions,
                                             check_options, set_preset)
    io, mo = IndexOptions(), MapOptions()
    set_preset(cfg["preset"], io, mo)
    io.k, io.w = cfg["k"], cfg["w"]
    for f in cfg["flags"]:
        if f not in CLI_FLAGS:
            raise ValueError(f"the benchmark does not apply the flag {f!r}")
        for bit in CLI_FLAGS[f]:
            set_option(mo, bit, True)
    mo.mini_batch_size = mix["batch_bp"]
    bad = {k: (v, option_value(mo, k)) for k, v in cfg["scoring"].items()
           if option_value(mo, k) != v}
    if bad:
        raise ValueError(f"the preset's scoring differs from the "
                         f"configuration's: {bad}")
    for k, v in (overrides or {}).items():
        set_option(mo, k, v)
    check_options(io, mo)
    return io, mo


def find_control(mix: dict, name: str) -> dict:
    """The mix's control (or fault) of that name."""
    for c in mix.get("controls", []):
        if c["name"] == name:
            return c
    raise KeyError(f"the mix has no control named {name!r}")


def install_control(control: dict | None):
    """Install a control's fault, wmbench/faults/<fault>.py found by name,
    with its args; returns the undo (nothing to undo for a control that
    only changes options)."""
    if not control or "fault" not in control:
        return lambda: None
    name = control["fault"]
    mod = _load_file(HERE / "faults" / f"{name}.py", f"wmbench_fault_{name}")
    return mod.install(control.get("args", {}))


class Cell:
    """A cell's set-up: genome, list, index, traffic, read pool, warm-up."""

    def __init__(self, manifest, name, seed, device=None, control=None,
                 base: Path = HERE, t_start=None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.stages = {}
        self.name, self.seed, self.device = name, seed, device
        (self.workload, self.centry, self.cfg, self.cfile,
         self.mix) = find_cell(manifest, name, base)
        self.control = control

    def _stage(self, name, t0):
        self.stages[name] = time.perf_counter() - t0

    def setup(self, spans, tmp: Path):
        import torch

        t = time.perf_counter()
        if self.device is None:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        self._stage("cuda", t)

        t = time.perf_counter()
        from winnowmap_tpu_torch import native
        from winnowmap_tpu_torch.extend import _build
        native.lib()
        if self.device is None:
            _build.load()
        self._stage("builds", t)

        t = time.perf_counter()
        gen = module(self.cfg["generator"])
        self.genome = gen.make_genome(self.cfg)
        self._stage("genome", t)

        t = time.perf_counter()
        from . import kmers
        list_path, self.list_made = kmers.weight_list(self.cfg, self.cfile,
                                                      self.genome)
        self._stage("list", t)

        t = time.perf_counter()
        from winnowmap_tpu_torch.index.build import (build_index,
                                                     load_weight_set)
        from winnowmap_tpu_torch.io.fastx import SeqRecord
        from winnowmap_tpu_torch.io.sam import sam_header
        from winnowmap_tpu_torch.options import update_mid_occ
        from winnowmap_tpu_torch import __version__
        self.io, self.mo = set_options(
            self.cfg, self.mix, (self.control or {}).get("options"))
        wset = load_weight_set(str(list_path), self.io.k)
        records = [SeqRecord(n, gen.to_bytes(c), None, None)
                   for n, c in zip(self.genome.names, self.genome.codes)]
        with spans.span("build_index"):
            self.mi = build_index(records, self.io.w, self.io.k,
                                  self.io.flag, wset,
                                  bool(self.io.flag & 1),
                                  device=self.device)
        del records
        update_mid_occ(self.mo, self.mi)
        self.n_listed = len(wset)
        self.header = sam_header(self.mi, None, __version__,
                                 "winnowmap-tpu wmbench " + self.name) + "\n"
        self._stage("index", t)

        t = time.perf_counter()
        rmod = module(self.mix["generator"])
        self.traffic = rmod.Traffic(self.genome, self.mix)
        self.make_pool(self.seed, tmp)
        # the warm-up maps a batch of loci of its own
        warm = self.traffic.batch(self.seed, self.mix["pool_batches"],
                                  self.mix["warmup_scale"])
        self.warm_path = tmp / "warmup.fa"
        self.warm_path.write_bytes(warm.fasta())
        self._stage("reads", t)

        t = time.perf_counter()
        self.map_one(self.warm_path, tmp / "warmup.sam")
        self._stage("warmup", t)

    def make_pool(self, seed: int, tmp: Path) -> None:
        """The seed's pool of batches, each written to a read file."""
        self.seed = seed
        self.pool, self.pool_paths = [], []
        for i in range(self.mix["pool_batches"]):
            b = self.traffic.batch(seed, i)
            p = tmp / f"reads{i}.fa"
            p.write_bytes(b.fasta())
            self.pool.append(b)
            self.pool_paths.append(p)

    def map_one(self, reads: Path, out_path: Path) -> int:
        from winnowmap_tpu_torch.map.pipeline import map_file
        with open(out_path, "w") as out:
            out.write(self.header)
            return map_file(self.mi, self.mo, str(reads), out,
                            device=self.device)


def window(cell: Cell, seconds: float, spans, tmp: Path) -> dict:
    """Map pool batches in turn while the window is open; a batch that
    starts before the close runs to its end.  Returns the window's
    bases, reads, batches, seconds and each batch's output file."""
    from winnowmap_tpu_torch.map.engine import STATS
    STATS.clear()
    before = dict(spans.seconds)
    outs, batch_s = [], []
    bases = reads = 0
    with spans.span("window"):
        t0 = time.perf_counter()
        t_end = t0
        i = 0
        while i == 0 or time.perf_counter() - t0 < seconds:
            b = i % len(cell.pool)
            out = tmp / f"out{i}.sam"
            with spans.span("map_file"):
                n = cell.map_one(cell.pool_paths[b], out)
            if n != len(cell.pool[b].names):
                raise RuntimeError(f"map_file mapped {n} of "
                                   f"{len(cell.pool[b].names)} reads")
            batch_s.append(time.perf_counter() - t_end)
            t_end = time.perf_counter()
            bases += cell.pool[b].bases
            reads += n
            outs.append((b, out))
            i += 1
    inside = {k: v - before.get(k, 0.0) for k, v in spans.seconds.items()}
    return {"t0": t0, "window_s": t_end - t0, "bases": bases,
            "spans": inside,
            "reads": reads, "batches": i, "outs": outs, "batch_s": batch_s,
            "stats": dict(STATS)}


def sample_reads(cell: Cell, used: list, n: int) -> dict:
    """qname -> (pool batch, index): n reads drawn from the seed over the
    pool batches the window used, with each batch's longest read."""
    from .reads import stream
    rng = stream(cell.seed, 1 << 20)
    pick = {}
    for b in used:
        lens = [len(s) for s in cell.pool[b].seqs]
        i = int(np.argmax(lens))
        pick[cell.pool[b].names[i]] = (b, i)
    every = [(b, i) for b in used for i in range(len(cell.pool[b].names))]
    for k in rng.permutation(len(every))[:max(0, n - len(pick))]:
        b, i = every[k]
        pick[cell.pool[b].names[i]] = (b, i)
    return pick


def check(cell: Cell, win: dict) -> tuple[dict, list, dict]:
    """Judge the window's output with the plain reference: a sample of
    reads drawn from the seed, in the last output of each pool batch the
    window used; every output of one pool batch must be the same bytes.
    Returns (numbers, faults, limits)."""
    ref = module(cell.cfg["reference"], "wmbench.reference")
    by_batch: dict = {}
    for b, out in win["outs"]:
        by_batch.setdefault(b, []).append(out)
    differing = sum(len({_file_digest(p) for p in outs}) - 1
                    for outs in by_batch.values())
    pick = sample_reads(cell, sorted(by_batch), cell.mix["sample_reads"])
    lines, reads = [], {}
    names = set(pick)
    for b, outs in by_batch.items():
        with open(outs[-1]) as f:
            for line in f:
                if line[0] == "@":
                    continue
                q = line[:line.index("\t")]
                if q in names:
                    lines.append(line.rstrip("\n").split("\t"))
    for q, (b, i) in pick.items():
        bt = cell.pool[b]
        reads[q] = (bt.seqs[i], (int(bt.chrom[i]), int(bt.start[i]),
                                 int(bt.end[i]), bool(bt.rev[i]),
                                 bool(bt.unique[i])))
    planted = None
    if cell.genome.genes:
        planted = {(g.chrom, int(s), int(e)) for g in cell.genome.genes
                   for s, e in g.introns}
    dp = None
    if "dp_window" in cell.mix:
        dp = dict(cell.mix["dp_window"], gaps=cell.cfg["dp_gaps"])
    nums, judge = ref.judge(lines, reads, cell.genome.names,
                            cell.genome.codes, cell.cfg["scoring"], planted,
                            dp)
    nums["batches_differing"] = differing
    limits = dict(cell.cfg["limits"], **cell.mix["limits"])
    return nums, judge.faults, limits


def run(manifest: dict, name: str, seed: int, seconds: float, trace: bool,
        device=None, log=print, control=None, base: Path = HERE,
        t_start=None) -> dict:
    """One run of a cell; returns the result object (and prints nothing
    but the log lines).  device None: the card; "cpu" runs the kernels'
    plain versions (the tests).  control: one of the mix's `controls`
    (the tests' runs only).  t_start: the process's start on
    time.perf_counter's clock, from which setup_s counts."""
    import torch
    from . import trace as tr

    cell = Cell(manifest, name, seed, device, control, base, t_start)
    spans = tr.Spans()
    tmp = Path(tempfile.mkdtemp(prefix="wmbench-"))
    undo = None
    undo_control = install_control(control)
    try:
        if trace:
            undo = tr.install(spans)
        cell.setup(spans, tmp)
        setup_s = time.perf_counter() - cell.t_start
        log("# setup stages (s): " + json.dumps(
            {k: round(v, 3) for k, v in cell.stages.items()})
            + f" first_run={json.dumps(cell.list_made or cell.stages['builds'] > 5)}"
            + f" listed_kmers={cell.n_listed}")
        prof = None
        if trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            spans.on = True
        try:
            win = window(cell, seconds, spans, tmp)
        finally:
            if prof is not None:
                spans.on = False
                prof.__exit__(None, None, None)
        dev_peak = (torch.cuda.max_memory_allocated()
                    if device is None else 0)
        log(f"# window: {win['batches']} batches, {win['reads']} reads, "
            f"{win['bases']} bases in {win['window_s']:.3f} s; device "
            f"peak {dev_peak} bytes; host peak RSS {peak_rss_gb():.3f} GB; "
            f"host {json.dumps(host_info())}; "
            f"batch s {[round(x, 3) for x in win['batch_s']]}")
        rec = {"window_s": win["window_s"], "bases": win["bases"],
               "reads": win["reads"], "stats": win["stats"],
               "setup": cell.stages,
               "spans": dict(win["spans"],
                             build_index=spans.seconds["build_index"])}
        breakdown = None
        if trace:
            rec.update(tr.read_trace(prof, spans))
            breakdown = rec.pop("breakdown")
            del prof
        # the program's state goes before the reference runs
        cell.mi.device_codes.clear()
        del cell.mi
        if device is None:
            torch.cuda.empty_cache()
        nums, faults, limits = check(cell, win)
        for q, why in faults:
            log(f"# fault: {q}: {why}")
        compared = {k: {"value": nums[k], "limit": limits[k]}
                    for k in limits}
        correct = all(v["value"] <= v["limit"] for v in compared.values())
        metrics = {}
        for m in cell_metrics(manifest, name, trace):
            if m["name"] == "setup_s":
                v = setup_s
            elif m["name"] == "input_Mbp_per_s":
                v = win["bases"] / 1e6 / win["window_s"]
            else:
                v = metric_reader(m["name"], base)(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out = {"correct": correct, "attempted": win["reads"], "failed": 0,
               "metrics": metrics,
               "device": {"platform": "gpu" if device is None else "cpu",
                          "kind": (torch.cuda.get_device_name()
                                   if device is None else "cpu"),
                          "count": 1, "memory_peak_bytes": dev_peak}}
        if trace:
            out["device"]["busy_s"] = rec["busy_s"]
            out["device"]["window_s"] = rec["trace_window_s"]
            out["breakdown"] = breakdown
        out["check"] = compared
        return out
    finally:
        if undo is not None:
            undo()
        undo_control()
        shutil.rmtree(tmp, ignore_errors=True)
