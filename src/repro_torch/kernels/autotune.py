"""Shape-keyed autotuner of the CUDA kernels' launch knobs (port of
``repro.kernels.autotune``).

JAX tunes the Pallas kernels' tiles (bm, br, bk, block_rows).  The port's
kernels fix their tiles at compile time; what they take at run time is a
split count of the reduction, which the wrappers pick by heuristics
sized for 132 SMs:

* B1 (``slide_matmul``) splits K at prefill (``splits``);
* B3 (``fused_slide_matmul``) splits gamma*K (``splits``);
* B2 (``paged_attention``) splits the page table (``br``, as JAX's
  paged attention names its S-splits).

B4 and B5 have no run-time knob: their candidates are ``[DEFAULT]``, and
their keys and records work as the others'.

* ``lookup``: a two-level cache, an in-process dict backed by a JSON
  file (``~/.cache/repro_torch/autotune.json``; ``REPRO_AUTOTUNE_CACHE``
  relocates it, ``REPRO_AUTOTUNE_CACHE=''`` turns the file off).
* ``autotune``: times each candidate with the caller's runner (CUDA
  events after a warm-up, each rep after an L2 flush, best of the reps)
  and records the winner, its roofline bound, efficiency and ``why``.
* ``tiles_for``: the ``ops.py`` entry point: cached -> the cached value;
  ``tune`` requested -> search; otherwise ``DEFAULT``, with which every
  wrapper launches its heuristic's value, so without a cache file the
  kernels launch what they launched before this module.

Cache file format (JAX's): ``{key: {"tiles": {bm, br, bk, block_rows,
splits}, "us": best_us, "backend": ...}}``, ``key`` being
``op|param=value|...`` over the shape/dtype parameters sorted by name,
then the backend (``cuda`` with the device's ``sm=``, or ``cpu``) and
``shards=`` (the tensor-parallel degree).  Null tiles mean the kernel's
heuristic.

JAX skips tuning under a tracer; the port skips it while a CUDA graph is
being captured (a capture records launches and runs none, so a timer
would read nothing) and on fake or meta tensors.  A cached entry still
applies inside a capture.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import warnings
from typing import Any, Callable, Iterable

import torch

from repro_torch.sharding import tp

from . import roofline

_FIELDS = ("bm", "br", "bk", "block_rows", "splits")

# candidates whose modeled traffic exceeds this multiple of the best
# candidate's cannot reach the bandwidth bound: skip timing them
PRUNE_RATIO = 2.0
# split counts tried (each normalized so that no split is empty)
SPLIT_OPTIONS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Launch knobs for one kernel call; None -> the kernel's heuristic."""

    bm: int | None = None
    br: int | None = None
    bk: int | None = None
    block_rows: int | None = None
    splits: int | None = None

    def kernel_kwargs(self, *names: str) -> dict[str, int]:
        """Non-None knobs restricted to the ones a kernel accepts."""
        return {f: getattr(self, f) for f in (names or _FIELDS)
                if getattr(self, f) is not None}


DEFAULT = TileConfig()

_MEM: dict[str, dict[str, Any]] = {}
_DIRTY: set[str] = set()  # keys recorded by THIS process (merge-on-write set)
_DISK_LOADED = False
# (the caller's memo of a call, shards) -> TileConfig: the key string
# and the lookup once per shape, not once per launch; emptied whenever
# the cache changes
_RESOLVED: dict[tuple, TileConfig] = {}
# timed candidate runs (the capture check reads it)
_COUNTS = {"timed": 0}


def cache_path() -> str | None:
    path = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if path == "":
        return None
    return path or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def _quarantine_cache(path: str, err: Exception) -> None:
    """A corrupt or truncated cache file must not take the kernels down
    or poison tuning: move it aside to ``<path>.bak``, warn, and continue
    with an empty cache that is re-tuned and rewritten atomically."""
    bak = path + ".bak"
    try:
        os.replace(path, bak)
        where = f"quarantined to {bak}"
    except OSError:
        where = "could not be quarantined (left in place, ignored)"
    warnings.warn(f"autotune cache {path} is corrupt ({err}); {where}; "
                  "continuing with an empty cache", RuntimeWarning,
                  stacklevel=3)


def _parse_cache(raw: str) -> dict[str, Any]:
    """Strict parse: a JSON object whose values are record objects;
    anything else raises ValueError."""
    disk = json.loads(raw)  # JSONDecodeError is a ValueError
    if not isinstance(disk, dict):
        raise ValueError(f"cache root is {type(disk).__name__}, not object")
    for key, rec in disk.items():
        if not isinstance(rec, dict):
            raise ValueError(f"record {key!r} is {type(rec).__name__}, "
                             "not object")
    return disk


def _load_disk() -> None:
    global _DISK_LOADED
    if _DISK_LOADED:
        return
    _DISK_LOADED = True
    path = cache_path()
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        return  # unreadable (permissions/races): run uncached
    try:
        disk = _parse_cache(raw)
    except (ValueError, UnicodeDecodeError) as e:
        _quarantine_cache(path, e)
        return
    for key, rec in disk.items():
        _MEM.setdefault(key, rec)


def _save_disk() -> None:
    """Atomic merge-on-write persistence: under a lock on a sidecar file,
    re-read the file, merge the keys this process tuned over it, dump to
    a temp file in the same directory and ``os.replace`` it, so readers
    see a whole old or new file and a concurrent writer's keys survive."""
    path = cache_path()
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".lock", "w") as lock:
            try:
                import fcntl
                fcntl.flock(lock, fcntl.LOCK_EX)
            except (ImportError, OSError):
                # no flock (non-POSIX, NFS without lockd): keep the atomic
                # replace, lose only the merge guard
                pass
            merged: dict[str, Any] = {}
            try:
                with open(path) as f:
                    merged = _parse_cache(f.read())
            except (OSError, ValueError, UnicodeDecodeError):
                merged = {}  # absent, torn, or corrupt: start fresh
            # only keys this process tuned: writing back entries loaded at
            # start would revert a concurrent writer's newer tuning
            merged.update({k: _MEM[k] for k in _DIRTY if k in _MEM})
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, path)  # readers never see a torn file
    except OSError:
        pass  # read-only filesystems must not break the kernels


def clear(memory_only: bool = True) -> None:
    """Drop the in-process cache (tests); optionally the disk file too."""
    global _DISK_LOADED
    _MEM.clear()
    _DIRTY.clear()
    _RESOLVED.clear()
    _DISK_LOADED = memory_only  # memory_only: don't re-read stale disk state
    if not memory_only:
        path = cache_path()
        if path and os.path.exists(path):
            os.remove(path)


@functools.cache
def backend() -> tuple[str, ...]:
    """The key's backend components: ('backend=cuda', 'sm=90') on a CUDA
    device, ('backend=cpu',) elsewhere."""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        return ("backend=cuda", f"sm={major}{minor}")
    return ("backend=cpu",)


def make_key(op: str, **params: Any) -> str:
    """Cache key over shape/dtype params + backend + TP shard count.

    ``shards=`` keeps single-device and tensor-parallel tunings apart:
    under TP a kernel sees local operand shards.  The ops.py callers pass
    ``adt=``/``wdt=`` (activation / weight precision) so an int8 winner
    is never reused for fp8 or w4 operands."""
    parts = [op] + [f"{k}={params[k]}" for k in sorted(params)]
    parts.extend(backend())
    parts.append(f"shards={tp.size()}")
    return "|".join(parts)


def lookup(key: str) -> TileConfig | None:
    _load_disk()
    rec = _MEM.get(key)
    if rec is None:
        return None
    tiles = rec.get("tiles", {})
    return TileConfig(**{f: tiles.get(f) for f in _FIELDS})


def record(key: str, tiles: TileConfig, us: float, *,
           roofline_us: float | None = None,
           why: str | None = None) -> None:
    """Cache ``tiles`` as the winner for ``key`` (in-process + disk), with
    the shape's bound and efficiency when ``roofline_us`` is given."""
    _load_disk()
    rec: dict[str, Any] = {"tiles": {f: getattr(tiles, f) for f in _FIELDS},
                           "us": us,
                           "backend": backend()[0].split("=")[1]}
    if roofline_us is not None:
        rec["roofline_us"] = roofline_us
        rec["efficiency"] = roofline_us / us if us > 0 else 0.0
    if why is not None:
        rec["why"] = why
    _MEM[key] = rec
    _DIRTY.add(key)
    _RESOLVED.clear()
    _save_disk()


# the L2 flush buffer: allocated at a search's first timing, freed at
# its end
_FLUSH: list = []


def _time(run: Callable[[TileConfig], Any], tiles: TileConfig,
          reps: int = 5) -> float:
    """Best-of-``reps`` time of one ``run(tiles)`` in µs, after a warm-up
    call: on the card device time between CUDA events, each rep after a
    write of 256 MB that evicts the 50 MB L2 (the main path finds each
    weight cold, and a warm-L2 reading could beat the bound) and a device
    spin that keeps host time out of the reading; elsewhere the host
    clock."""
    import time
    _COUNTS["timed"] += 1
    run(tiles)  # warm-up (a first launch builds and loads the kernel)
    best = float("inf")
    on_card = torch.cuda.is_available()
    if on_card and not _FLUSH:
        _FLUSH.append(torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                  device="cuda"))
    for _ in range(reps):
        if on_card:
            _FLUSH[0].zero_()
            # the device spins ~0.2 ms, so the host has enqueued the call
            # before the start event is reached: no host time is read
            torch.cuda._sleep(400_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(tiles)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) * 1e3)
        else:
            t0 = time.perf_counter()
            run(tiles)
            best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def split_options(stages: int, most: int | None = None) -> list[int]:
    """The split counts of ``stages`` reduction steps that leave no split
    empty (``ceil(stages / ceil(stages / s))`` of each option), at most
    ``most``."""
    out = []
    for s in SPLIT_OPTIONS:
        s = -(-stages // -(-stages // min(s, max(1, stages))))
        if (most is None or s <= most) and s not in out:
            out.append(s)
    return out


def candidates(op: str, rows: int, m: int, k: int,
               **params: Any) -> list[TileConfig]:
    """Small per-op search spaces over the knobs the CUDA kernels take
    (tuning runs the real kernel), sized against the ROWS BUCKET as JAX
    sizes its tiles: the winner is cached per bucket.  ``params``: the
    key params (``pattern`` for B1/B3, ``adt``)."""
    rows = rows_bucket(rows)
    n = roofline._pattern_n(params)
    if op == "compressed_matmul" and n and str(params.get("adt")) == "int8":
        from . import slide_matmul as smm
        if rows <= smm.DECODE_MAX_R:
            return [DEFAULT]  # the decode instance takes no split
        stages = -(-k // smm.prefill_stage(n))
        return [DEFAULT] + [TileConfig(splits=s) for s in split_options(
            stages, max(1, stages // smm.MIN_SPLIT_STAGES))]
    if op == "fused_slided_matmul" and n and str(params.get("adt")) == "int8":
        from . import fused_slide_matmul as fsm
        gk = roofline.lifted_k(k, n)
        stages = -(-(-(-gk // fsm.KSTEP)) // fsm.STAGE_KS)
        opts = split_options(stages)
        if rows <= fsm.DECODE_MAX_R:  # a decode split lifts <= 32 stages
            opts = [s for s in opts if -(-stages // s) <= fsm.DEC_MAX_STAGES]
        return [DEFAULT] + [TileConfig(splits=s) for s in opts]
    if op == "paged_attention":
        from . import paged_attention as pa
        most = max(1, k // pa.MIN_SPLIT_TOKENS)
        return [DEFAULT] + [TileConfig(br=s) for s in SPLIT_OPTIONS
                            if s <= min(most, pa.MAX_SPLITS)]
    return [DEFAULT]


def autotune(op: str, run: Callable[[TileConfig], Any],
             cands: Iterable[TileConfig] | None = None, *,
             key: str | None = None, rows: int = 0, m: int = 0,
             k: int = 0, params: dict[str, Any] | None = None,
             priced_k: float | None = None) -> TileConfig:
    """Time every candidate with ``run`` and cache the fastest under
    ``key``; candidates whose modeled traffic exceeds ``PRUNE_RATIO`` x the
    least are pruned without timing.  A candidate the wrapper refuses
    (ValueError) is skipped; a failed build or launch raises.  The
    entry's bound is ``roofline.op_cost`` at ``priced_k`` in place of
    ``k`` where given (B2: the tokens the timed call reads)."""
    params = params or {}
    cand_list = list(cands if cands is not None
                     else candidates(op, rows, m, k, **params))
    traffic = {i: roofline.tile_traffic(op, rows=rows, m=m, k=k, br=t.br,
                                        bm=t.bm, splits=t.splits, **params)
               for i, t in enumerate(cand_list)}
    known = [v for v in traffic.values() if v is not None]
    floor = min(known) if known else None
    best_tiles, best_us = DEFAULT, float("inf")
    pruned = timed = 0
    for i, tiles in enumerate(cand_list):
        tr = traffic[i]
        if (floor is not None and tr is not None
                and tr > PRUNE_RATIO * floor):
            pruned += 1
            continue
        try:
            us = _time(run, tiles)
        except ValueError:
            continue  # candidate invalid for this shape
        timed += 1
        if us < best_us:
            best_tiles, best_us = tiles, us
    _FLUSH.clear()  # the flush buffer is tuning's alone
    if key is not None and best_us != float("inf"):
        cost = roofline.op_cost(op, rows=rows, m=m,
                                k=k if priced_k is None else priced_k,
                                **params)
        p = roofline.peaks(params.get("adt") or params.get("xdt"))
        bound = roofline.roofline_us(cost, p) if cost is not None else None
        why = (f"best of {timed} timed / {len(cand_list)} candidates"
               f" ({pruned} roofline-pruned)")
        if bound is not None:
            why += (f"; achieved {best_us:.1f}us vs {bound:.1f}us bound"
                    f" ({bound / best_us:.1%})")
        record(key, best_tiles, best_us, roofline_us=bound, why=why)
    return best_tiles


def rows_bucket(rows: int) -> int:
    """Round the (dynamic, batch-dependent) row count up to a power of two so
    serving batch jitter doesn't fragment the cache."""
    return max(8, 1 << max(0, rows - 1).bit_length())


def tracing(*operands: Any) -> bool:
    """True where a timer would read nothing: a CUDA graph is being
    captured on the current stream (JAX: an operand is a tracer), or an
    operand is a fake or meta tensor (the dry run)."""
    from torch._subclasses.fake_tensor import FakeTensor
    if any(isinstance(a, FakeTensor) or getattr(a, "is_meta", False)
           for a in operands):
        return True
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def resolved(memo: tuple) -> TileConfig | None:
    """What ``tiles_for`` resolved for the caller's ``memo`` under this
    TP degree, or None (a dict lookup: the per-launch fast path)."""
    return _RESOLVED.get((memo, tp.size()))


def tiles_for(op: str, *, rows: int, m: int, k: int, tune: bool = False,
              run: Callable[[TileConfig], Any] | None = None,
              operands: tuple = (), memo: tuple | None = None,
              priced_k: Callable[[], float] | None = None,
              **key_params: Any) -> TileConfig:
    """Cached knobs for (op, shape); a search when ``tune`` (skipped while
    ``tracing``); otherwise ``DEFAULT`` (the kernel's heuristic).
    ``priced_k()``, read only when a search runs: the k its entry's bound
    prices (``autotune``'s ``priced_k``)."""
    # ``memo``: the caller's hashable of the call's shapes and types, which
    # determine the key; by default the params in the caller's order (one
    # call site passes them in one order; another only adds an entry)
    if memo is None:
        memo = (op, rows, m, k, *key_params.items())
    memo = (memo, tp.size())
    got = _RESOLVED.get(memo)
    if got is not None and (got is not DEFAULT or not tune):
        return got
    key = make_key(op, rows=rows_bucket(rows), m=m, k=k, **key_params)
    cached = lookup(key)
    if cached is not None:
        _RESOLVED[memo] = cached
        return cached
    if tune and run is not None and not tracing(*operands):
        return autotune(op, run, key=key, rows=rows, m=m, k=k,
                        params=key_params,
                        priced_k=priced_k() if priced_k else None)
    if not tune:
        _RESOLVED[memo] = DEFAULT
    return DEFAULT
