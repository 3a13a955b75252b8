"""The compiled K1-K3 as the card runs them, and what a call does on the card.

The contract analyzer's card half reads:

* the code of the built libraries (``kernels/build.py`` embeds each
  source's ``compute_90a`` PTX beside its ``sm_90a`` cubin, so the PTX
  read here is the very program ptxas assembled): per kernel instance, the
  SASS opcode counts (``cuobjdump --dump-sass``), the PTX body
  (``cuobjdump --dump-ptx``) and the static shared memory
  (``cuobjdump --dump-resource-usage``), names demangled by ``cu++filt``;
* the device activity of one call, from ``torch.profiler``'s trace: the
  kernels with the shared memory each launch asked for, and any memcpy or
  memset.

A missing tool, a listing with no functions, or an instance the wrappers
can launch that the listing lacks raises
:class:`~repro_torch.analysis.rules.AnalysisError`: nothing passes
unread.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import shutil
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.rules import AnalysisError

__all__ = [
    "LIBRARIES",
    "Instance",
    "launchable_instances",
    "parse_sass",
    "parse_ptx",
    "parse_resource_usage",
    "instance_key",
    "Program",
    "compiled_program",
    "compiled_programs",
    "sass_ring_sites",
    "k2_source_sites",
    "profile_call",
]

# Library (csrc/<name>.cu) -> its kernel template.
LIBRARIES = {"edge": "edge_kernel", "edge_pipelined": "pipelined_kernel",
             "edge_stream": "stream_kernel"}

# K1's and K2's lanes (input, accumulator), csrc/edge.cu:160-171 and
# csrc/edge_pipelined.cu:655-666; K3 has the f32 lane only.
# Shared memory a Hopper CTA reserves for the system: cuobjdump's SHARED
# counts it in each function, the profiler's launch record does not.
RESERVED_SMEM = 1024

_LANES = (("unsigned char", "int"), ("unsigned char", "float"), ("float", "float"))
_SIZES = (3, 5, 7, 9)  # REPRO_SWITCH_SIZE, csrc/edge_tile.cuh
_CONST = ("Sobel5Default<4>", "Sobel5Default<2>")


@dataclasses.dataclass(frozen=True)
class Instance:
    """One template instance: ``kernel<size, input, accum, taps, pre>`` (K3
    has no accumulator and no pre-stage argument)."""

    kernel: str
    size: int
    input: str
    accum: Optional[str]
    taps: str
    pre: Optional[bool]

    @property
    def key(self) -> str:
        args = [str(self.size), self.input]
        if self.accum is not None:
            args.append(self.accum)
        args.append(self.taps)
        if self.pre is not None:
            args.append("true" if self.pre else "false")
        return f"{self.kernel}<{', '.join(args)}>"


def launchable_instances() -> List[Instance]:
    """Every instance the wrappers can launch, as the C entry points
    dispatch: K1 and K2 per lane the compile-time sobel5 (2 and 4
    directions) and the run-time-taps instance of each size, each with and
    without pre-stages (``launch_lane``, ``launch``); K3 per input the same
    taps, without pre-stages or an integer lane (``launch_input``)."""
    out: List[Instance] = []
    for kernel in ("edge_kernel", "pipelined_kernel"):
        for inp, acc in _LANES:
            taps = [(5, p) for p in _CONST] + [(k, f"RtTaps<{acc}>") for k in _SIZES]
            for size, p in taps:
                for pre in (False, True):
                    out.append(Instance(kernel, size, inp, acc, p, pre))
    for inp in ("unsigned char", "float"):
        taps = [(5, p) for p in _CONST] + [(k, "RtTaps<float>") for k in _SIZES]
        for size, p in taps:
            out.append(Instance("stream_kernel", size, inp, None, p, None))
    return out


def _split_args(text: str) -> List[str]:
    """Top-level comma split of a template argument list."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    parts.append(cur.strip())
    return parts


def instance_key(demangled: str) -> Optional[str]:
    """The :attr:`Instance.key` of a demangled kernel name (``void
    edge_kernel<5, unsigned char, int, Sobel5Default<4>, false>(...)``),
    or None for another function. cu++filt spells a bool as ``(bool)1``
    and an int as ``(int)5``; the key spells them ``true`` and ``5``."""
    demangled = re.sub(r"\((?:int|long|unsigned int)\)(-?\d+)", r"\1", demangled)
    demangled = re.sub(r"\(bool\)([01])",
                       lambda b: "true" if b.group(1) == "1" else "false", demangled)
    m = re.search(r"\b(edge_kernel|pipelined_kernel|stream_kernel)<", demangled)
    if m is None:
        return None
    i, depth = m.end(), 1
    while i < len(demangled) and depth:
        depth += {"<": 1, ">": -1}.get(demangled[i], 0)
        i += 1
    args = _split_args(demangled[m.end():i - 1])
    return f"{m.group(1)}<{', '.join(args)}>"


_SASS_FN = re.compile(r"^\s*Function\s*:\s*(\S+)")
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def parse_sass(text: str) -> Dict[str, collections.Counter]:
    """``cuobjdump --dump-sass`` text -> {mangled function: opcode counts}."""
    out: Dict[str, collections.Counter] = {}
    cur = None
    for line in text.splitlines():
        m = _SASS_FN.match(line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        if cur is not None:
            op = _SASS_OP.search(line)
            if op:
                cur[op.group(1)] += 1
    return out


_PTX_FN = re.compile(r"^\s*(?:\.visible\s+|\.weak\s+)?\.(?:entry|func)\s+(?:\([^)]*\)\s*)?(\w+)")


def parse_ptx(text: str) -> Dict[str, str]:
    """``cuobjdump --dump-ptx`` text -> {mangled function: its PTX}."""
    out: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = _PTX_FN.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
        if cur is not None:
            cur.append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def parse_resource_usage(text: str) -> Dict[str, int]:
    """``cuobjdump --dump-resource-usage`` text -> {mangled function: its
    SHARED bytes (the function's static shared memory and the
    :data:`RESERVED_SMEM` the card reserves)}."""
    out: Dict[str, int] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s+(\S+?):?\s*$", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"\bSHARED:(\d+)", line)
        if cur is not None and m:
            out[cur] = int(m.group(1))
            cur = None
    return out


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise AnalysisError(
            f"{name} not found (looked on PATH and in /usr/local/cuda/bin); the card "
            "half reads the compiled kernels with the CUDA toolkit's tools"
        )
    return path


def _run(cmd: List[str], stdin: Optional[str] = None) -> str:
    try:
        proc = subprocess.run(cmd, input=stdin, capture_output=True, text=True, timeout=900)
    except subprocess.TimeoutExpired as e:
        raise AnalysisError(f"{' '.join(cmd[:2])} timed out") from e
    if proc.returncode != 0:
        raise AnalysisError(f"{' '.join(cmd[:2])} failed: {proc.stderr.strip()[:400]}")
    return proc.stdout


def _demangle(names: List[str]) -> Dict[str, str]:
    if not names:
        return {}
    out = _run([_tool("cu++filt")], stdin="\n".join(names) + "\n").splitlines()
    if len(out) != len(names):
        raise AnalysisError(f"cu++filt returned {len(out)} names for {len(names)}")
    return dict(zip(names, out))


@dataclasses.dataclass
class Program:
    """One library's compiled instances, keyed by :attr:`Instance.key`."""

    library: str
    sass: Dict[str, collections.Counter]
    ptx: Dict[str, str]
    static_smem: Dict[str, int]  # the function's own static shared memory
    helpers: Dict[str, str]  # PTX of the device functions the instances call, by name
    functions: Dict[str, int]  # functions found per listing
    seconds: Dict[str, float]
    per_instance: Dict[str, int] = dataclasses.field(default_factory=dict)  # SASS functions


def compiled_program(library: str) -> Program:
    """Build ``csrc/<library>.cu`` if needed and read its compiled code.

    Raises :class:`AnalysisError` when a tool is missing, a listing holds
    no function, or an instance :func:`launchable_instances` lists for the
    library is absent from the SASS or the PTX."""
    from repro_torch.kernels import build

    build.build([library])
    lib = str(build.library_path(library))
    cuobjdump = _tool("cuobjdump")
    seconds = {}
    t0 = time.perf_counter()
    ptx = parse_ptx(_run([cuobjdump, "--dump-ptx", lib]))
    seconds["ptx"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sass = parse_sass(_run([cuobjdump, "--dump-sass", lib]))
    seconds["sass"] = time.perf_counter() - t0
    smem = parse_resource_usage(_run([cuobjdump, "--dump-resource-usage", lib]))
    if any(v < RESERVED_SMEM for v in smem.values()):
        raise AnalysisError(f"{lib}: a function's SHARED is below the {RESERVED_SMEM} B the "
                            "card reserves; the static shared memory cannot be read")
    smem = {m: v - RESERVED_SMEM for m, v in smem.items()}
    for what, listing in (("SASS", sass), ("PTX", ptx)):
        if not listing:
            raise AnalysisError(f"the {what} listing of {lib} holds no function")
    names = _demangle(sorted(set(sass) | set(ptx) | set(smem)))
    keyed = {m: instance_key(d) for m, d in names.items()}

    def by_key(listing):
        return {keyed[m]: v for m, v in listing.items() if keyed.get(m)}

    helpers = {names[m]: body for m, body in ptx.items() if not keyed.get(m)}
    prog = Program(library, by_key(sass), by_key(ptx), by_key(smem), helpers,
                   {"sass": len(sass), "ptx": len(ptx)}, seconds,
                   dict(collections.Counter(keyed[m] for m in sass if keyed.get(m))))
    kernel = LIBRARIES[library]
    want = {i.key for i in launchable_instances() if i.kernel == kernel}
    for what, listing in (("SASS", prog.sass), ("PTX", prog.ptx),
                          ("resource usage", prog.static_smem)):
        missing = sorted(want - set(listing))
        twice = sorted(k for k, n in prog.per_instance.items() if n != 1)
        if twice:
            raise AnalysisError(f"the SASS of {lib} holds {twice[0]} "
                                f"{prog.per_instance[twice[0]]} times")
        if missing:
            raise AnalysisError(
                f"the {what} of {lib} lacks {len(missing)} of the {len(want)} instances the "
                f"wrapper can launch, e.g. {missing[0]}"
            )
    return prog


def compiled_programs() -> Dict[str, Program]:
    """:func:`compiled_program` of K1, K2 and K3, read in parallel (the
    SASS listings run to ~100 MB each). Builds them first, together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    try:
        build.build(list(LIBRARIES))
    except RuntimeError as e:  # no nvcc, or a source that does not compile
        raise AnalysisError(str(e).splitlines()[0]) from e
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        progs = list(pool.map(compiled_program, LIBRARIES))
    return dict(zip(LIBRARIES, progs))


_COPY_SITE = re.compile(r"cp\.async\.(?:cg\.shared\.global|bulk\.tensor)")
_WAIT_SITE = re.compile(r"mbarrier\.try_wait")


def k2_source_sites(text: str) -> Tuple[int, int]:
    """``(copies, waits)``: the lines of K2's source (comments dropped)
    that issue a ring copy (16-byte ``cp.async`` or a TMA box) and that
    wait on a slot's mbarrier."""
    copies = waits = 0
    for line in text.splitlines():
        code = line.split("//", 1)[0]
        copies += bool(_COPY_SITE.search(code))
        waits += bool(_WAIT_SITE.search(code))
    return copies, waits


SASS_COPIES = ("UTMALDG", "LDGSTS")
SASS_WAITS = ("SYNCS.PHASECHK",)  # mbarrier.try_wait: SYNCS.PHASECHK.TRANS64.TRYWAIT


def sass_ring_sites(ops: collections.Counter) -> Tuple[int, int]:
    """``(copies, waits)`` of one K2 instance's SASS: TMA loads
    (``UTMALDG``) and 16-byte async copies (``LDGSTS``), and mbarrier
    try-waits (``SYNCS.PHASECHK``)."""
    copies = sum(n for op, n in ops.items() if op.startswith(SASS_COPIES))
    waits = sum(n for op, n in ops.items() if op.startswith(SASS_WAITS))
    return copies, waits


def profile_call(fn: Callable[[], object], trace_dir, attempts: int = 5) -> List[dict]:
    """Run ``fn`` once under ``torch.profiler`` and return its device
    activity in order: ``{"cat", "name", "smem"}`` per kernel, memcpy and
    memset (``smem``: the shared memory a kernel launch used, static and
    dynamic, as the profiler records it; None for the others).

    A one-element PyTorch fill follows ``fn`` inside the window and is
    dropped from the result. On an H100 the profiler returned short
    windows without their device records once the process had profiled and
    then idled ~30 s (``sweep`` profiles in a fresh process for that); a
    record without the fill is such a one, is counted in
    ``profile_call.dropped`` and is taken again, up to ``attempts`` times,
    after which this raises :class:`AnalysisError`: an unread record never
    passes."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(str(trace_dir), f"trace-{os.getpid()}.json")
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
            torch.ones(1, device=torch.device("cuda", torch.cuda.current_device()))
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path, "r", encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
        os.unlink(path)
        out = []
        for e in sorted((e for e in events if e.get("ph") == "X"),
                        key=lambda e: e.get("ts", 0)):
            cat = str(e.get("cat", ""))
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                smem = e.get("args", {}).get("shared memory")
                out.append({"cat": cat, "name": str(e.get("name", "")),
                            "smem": None if smem is None else int(smem)})
        if out and "FillFunctor" in out[-1]["name"]:
            return out[:-1]
        profile_call.dropped += 1
    raise AnalysisError(f"the profiler's record lacked the fill launched after the call "
                        f"{attempts} times; its device activity cannot be read")


profile_call.dropped = 0
