"""Atomic, restart-safe, packed-native checkpoints in one process (port
of the single-process half of :mod:`repro.distributed.checkpoint`).

Layout (one directory per step, committed by atomic rename)::

    <ckpt_dir>/step_00000420/
        manifest.json       # leaf keys, shapes, dtypes, crc32s, step
        <leaf-key>.npy      # one file per tree leaf

The files are byte for byte the reference's, so a checkpoint written by
either package restores in the other, leaf for leaf:

  * **Keys** are the reference's: ``jax.tree_util.keystr`` of the leaf's
    path, sanitised.  A dict key is ``['k']``, and a tuple key (the
    port's ``Model.param_tree`` paths) expands into one ``['k']`` per
    element, as the reference's nested dicts give; a NamedTuple field is
    ``.field``; a list or tuple item ``[i]``; ``None`` adds no leaf.
    Dicts flatten in sorted key order, NamedTuples in field order.
  * **bf16 words** go to disk as the reference's ``ml_dtypes`` arrays do:
    an ``.npy`` header with descr ``'<V2'`` over the raw 16-bit words
    (numpy has no bf16, and the port imports no ``ml_dtypes``).
  * **Python ints** (the port's optimizer ``step``) are stored as 0-d
    int32, the reference's ``step``, and restore as int.

Guarantees, as in the reference:

  * **Atomicity**: leaves and manifest are written into
    ``step_N.tmp-<pid>-<tid>``, each file fsynced, and the directory is
    renamed only then.  Re-saving a step goes through ``step_N.old``
    (rename the old copy aside, rename the new one in, delete the old);
    a crash between the two renames leaves ``.old`` as the only complete
    copy, which :func:`recover_stale` renames back on the read path.
  * **Integrity**: every leaf carries the crc32 of its whole file in the
    manifest, checked on restore.
  * **Packed-native symmetric state**: :class:`PackedTriangle`,
    :class:`TriTiles` and :class:`ShardedTriTiles` leaves are stored as
    their element-packed words (f32 / f64 narrowed to bf16 by default)
    with the layout in the manifest's ``packed`` entry; restore rebuilds
    whatever layout the ``like`` leaf asks for (another tile size, a
    ``ShardedTriTiles`` at another ``c``, or the dense mirrored matrix).
  * **Async**: ``save_checkpoint(..., blocking=False)`` copies every leaf
    to host memory before it returns (the train step updates parameters
    in place, so the snapshot must not alias them) and writes on a
    daemon thread; :func:`wait_for_saves` joins the writers and raises
    the first error one of them met.
  * **Retention**: keeps the newest ``keep`` checkpoints and sweeps the
    debris of crashed saves, never a live writer's.

  * **Meshes**: given the ``mesh`` and the parameters' ``specs``
    (``models.sharding.param_specs``), the tree is this rank's blocks: a
    leaf under a dict keyed by the parameter paths (the parameters, the
    momentum, the moments, the EF residuals, the Grams) takes its
    parameter's spec by path, any other leaf is whole on every rank.
    :func:`save_checkpoint` gathers each split leaf over its axes, one
    leaf at a time, to rank 0's host memory (a Gram's
    :class:`PackedTriangleSlice` slices join into one
    :class:`PackedTriangle`, the padding dropped) and rank 0 writes the
    same files as a single-device save; :func:`restore_checkpoint`
    gives every rank its block of each leaf under the current mesh (a
    Gram its slice for the current split), so a checkpoint restores
    onto any layout and device count; :func:`verify_restored` gathers
    the placed blocks back and checks their crcs.

``_fsync_fd`` and ``_rename`` are the only I/O sites of the commit
protocol, each under :func:`~repro_torch.distributed.resilience.with_retries`
and each a fault site (``ckpt:fsync``, ``ckpt:rename``) of
:mod:`~repro_torch.distributed.faults`.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.packing import (PackedTriangle, PackedTriangleSlice,
                            ShardedTriTiles, TriTiles, pack_tril,
                            unpack_tril)
from . import collectives, faults
from .resilience import with_retries

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_RE = re.compile(r"^step_\d{8}\.tmp-(\d+)-\d+$")
_OLD_RE = re.compile(r"^step_(\d{8})\.old$")
_PENDING: List[threading.Thread] = []
_ERRORS: List[BaseException] = []
_PENDING_LOCK = threading.Lock()
#: tmp directories this process is writing (guarded by _PENDING_LOCK):
#: the orphan sweep never touches them
_ACTIVE_TMP: set = set()

#: default narrow dtype of packed symmetric leaves (None keeps the source)
PACKED_DTYPE = "bfloat16"

_PACKED_TYPES = (TriTiles, ShardedTriTiles, PackedTriangle,
                 PackedTriangleSlice)

#: numpy has no bf16: its words go to disk as the reference's ml_dtypes
#: array does, the int16 bits under this void header descr
_BF16_DESCR = "<V2"

HostLeaf = Tuple[str, np.ndarray, str]          # (key, words, dtype name)


def _is_packed_leaf(x) -> bool:
    return isinstance(x, _PACKED_TYPES)


def _dtype_name(dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "int8")."""
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"no torch dtype {name!r}")
    return dtype


# -- tree walk: the reference's leaf order and keys ------------------------
def _walk(tree: Any, path: str) -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in ``jax.tree_util`` flattening order."""
    if tree is None:
        return
    if _is_packed_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            seg = "".join(f"[{e!r}]" for e in
                          (k if isinstance(k, tuple) else (k,)))
            yield from _walk(tree[k], path + seg)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` in
    :func:`_walk` order (dicts keep ``like``'s key order)."""
    if like is None:
        return None
    if _is_packed_leaf(like):
        return next(leaves)
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _leaf_key(path: str) -> str:
    """Stable, filesystem-safe key for a leaf path."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path).strip("_") or "leaf"


def _leaf_specs(tree: Any, specs: Optional[Dict[Any, Any]]) -> list:
    """Each leaf's spec, in :func:`_flatten`'s order: a leaf under a dict
    whose keys are the parameter paths of ``specs`` takes its
    parameter's spec (by path, never by shape: wq and wo share a shape
    and not a split); any other leaf None (whole on every rank), as is a
    tensor of another rank than its spec's (a Gram's empty placeholder
    beside a parameter that is not a matrix)."""
    out: list = []

    def walk(t, spec) -> None:
        if t is None:
            return
        if isinstance(t, torch.Tensor) and spec is not None \
                and len(spec) != t.ndim:
            out.append(None)
        elif _is_packed_leaf(t):
            out.append(spec)
        elif isinstance(t, dict):
            keyed = specs is not None and set(t) == set(specs)
            for k in sorted(t):
                walk(t[k], specs[k] if keyed else spec)
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), spec)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, spec)
        else:
            out.append(spec)

    walk(tree, None)
    return out


def _split_axes(spec) -> List[str]:
    """The mesh axes a spec splits over, in order."""
    axes: List[str] = []
    for a in spec or ():
        axes.extend((a,) if isinstance(a, str) else (a or ()))
    return axes


def _whole(leaf: Any, spec, mesh) -> Any:
    """The whole leaf from this rank's block under ``spec``, on the rank
    that holds the first block of each axis the leaf is split over (a
    Gram's slices joined into its :class:`PackedTriangle`), None on the
    others; a leaf split over no axis as it is.  Collective on the ranks
    of each axis, counted by :mod:`.collectives` under ``gather``; on a
    gloo mesh the blocks go to the host first, where the whole leaf is
    wanted."""
    from ..models.sharding import gather_leaf
    axes = _split_axes(spec)
    if not axes or not isinstance(leaf, (torch.Tensor,
                                         PackedTriangleSlice)):
        return leaf
    host = mesh.backend == "gloo"
    if isinstance(leaf, PackedTriangleSlice):
        [axis] = axes
        comm = mesh.comm(axis)
        if (comm.size, comm.index) != (leaf.parts, leaf.index):
            raise ValueError(f"slice {leaf.index} of {leaf.parts} on axis "
                             f"{axis!r} at index {comm.index} of "
                             f"{comm.size}")
        vec = leaf.vec.cpu() if host else leaf.vec
        parts = collectives.gather(vec[None], comm)
        if parts is None:
            return None
        return PackedTriangle(PackedTriangleSlice.join(
            [PackedTriangleSlice(v, leaf.n, leaf.parts, i)
             for i, v in enumerate(parts)]), leaf.n)
    return gather_leaf(leaf.cpu() if host else leaf, spec, mesh,
                       first=True)


def _block(t: torch.Tensor, spec, mesh, device) -> torch.Tensor:
    """This rank's block of the whole host tensor ``t`` under ``spec``,
    in memory of its own on ``device``."""
    from ..models.sharding import shard_leaf
    if _split_axes(spec):
        t = shard_leaf(t, spec, mesh)
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    return out.copy_(t)


def _flatten(tree: Any) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs; packed symmetric formats are ONE leaf each."""
    out = []
    seen: Dict[str, int] = {}
    for path, leaf in _walk(tree, ""):
        k = _leaf_key(path)
        if k in seen:             # disambiguate collisions deterministically
            seen[k] += 1
            k = f"{k}__{seen[k]}"
        else:
            seen[k] = 0
        out.append((k, leaf))
    return out


# -- host words and the .npy encoding ----------------------------------------
def _host(v: Any, copy: bool) -> Tuple[np.ndarray, str]:
    """One leaf as host words and its dtype name.  ``copy`` makes the
    words independent of the leaf's memory even where it lies on the
    host already (a CPU tensor's ``.numpy()`` would alias it)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=copy).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    if isinstance(v, int) and not isinstance(v, bool):
        arr = np.asarray(v, dtype=np.int32)
    else:
        arr = np.array(v) if copy else np.asarray(v)
    return arr, str(arr.dtype)


def _packed_meta(leaf) -> Dict[str, Any]:
    """Manifest layout metadata for one packed symmetric leaf."""
    if isinstance(leaf, PackedTriangleSlice):
        raise TypeError("a PackedTriangleSlice is saved whole: pass the "
                        "mesh and specs to save_checkpoint")
    src = _dtype_name(leaf.dtype)
    if isinstance(leaf, ShardedTriTiles):
        return {"format": "sharded_tritiles", "n": leaf.n, "c": leaf.c,
                "fill": "sym", "source_dtype": src}
    if isinstance(leaf, TriTiles):
        return {"format": "tritiles", "n": leaf.n, "bm": leaf.bm,
                "fill": "sym", "source_dtype": src}
    return {"format": "packed_triangle", "n": leaf.n, "fill": "sym",
            "source_dtype": src}


def _packed_vec(leaf) -> torch.Tensor:
    """The element-packed words of a packed leaf (block / slice-granular
    exits: no dense n × n on the way)."""
    return leaf.vec if isinstance(leaf, PackedTriangle) else leaf.to_packed()


def _host_packed(leaf, dtype: Optional[str], copy: bool
                 ) -> Tuple[np.ndarray, str]:
    """Packed leaf -> host words, f32 / f64 narrowed to ``dtype`` on the
    leaf's device first."""
    vec = _packed_vec(leaf)
    if dtype is not None and vec.dtype in (torch.float32, torch.float64):
        vec = vec.to(_torch_dtype(dtype))
    return _host(vec, copy)


def _npy_header(arr: np.ndarray, name: str) -> bytes:
    """The header ``np.save`` writes for these words (for a void dtype,
    the one it writes for the reference's ml_dtypes array)."""
    d = ({"descr": _BF16_DESCR, "fortran_order": False,
          "shape": arr.shape} if name == "bfloat16"
         else np.lib.format.header_data_from_array_1_0(arr))
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, d)
    return buf.getvalue()


def _npy_parts(arr: np.ndarray, name: str) -> Tuple[bytes, np.ndarray]:
    """(header, raw words as a flat uint8 view): the .npy file's bytes."""
    arr = np.asarray(arr, order="C")
    return _npy_header(arr, name), arr.reshape(-1).view(np.uint8)


def _npy_crc(arr: np.ndarray, name: str) -> int:
    head, data = _npy_parts(arr, name)
    return zlib.crc32(data, zlib.crc32(head))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


#: transient-I/O retry policy of the commit protocol (fsync / rename):
#: network and overlay filesystems surface retryable EIO / ESTALE here,
#: and the chaos harness injects :class:`~.faults.FaultError` (an
#: OSError) at the same sites
_IO_RETRIES = dict(retries=3, backoff=0.01, retry_on=(OSError,))


def _fsync_fd(fd: int) -> None:
    faults.maybe_fail("ckpt:fsync")
    os.fsync(fd)


def _rename(src: str, dst: str) -> None:
    faults.maybe_fail("ckpt:rename")
    os.rename(src, dst)


def _write(ckpt_dir: str, step: int, host_leaves: List[HostLeaf],
           keep: int, extra: Dict[str, Any],
           packed_meta: Dict[str, Dict[str, Any]]) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
    with _PENDING_LOCK:
        _ACTIVE_TMP.add(tmp)
    try:
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}, "extra": extra}
        for key, arr, name in host_leaves:
            head, data = _npy_parts(arr, name)
            with open(os.path.join(tmp, key + ".npy"), "wb") as f:
                f.write(head)
                f.write(data)
                f.flush()
                with_retries(_fsync_fd, f.fileno(), **_IO_RETRIES)
            entry = {"shape": list(arr.shape), "dtype": name,
                     "crc": zlib.crc32(data, zlib.crc32(head)),
                     "bytes": arr.nbytes}
            if key in packed_meta:
                entry["packed"] = packed_meta[key]
            manifest["leaves"][key] = entry
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            with_retries(_fsync_fd, f.fileno(), **_IO_RETRIES)
        if os.path.exists(final):  # same step re-saved: replace atomically
            with_retries(_rename, final, final + ".old", **_IO_RETRIES)
            with_retries(_rename, tmp, final, **_IO_RETRIES)
            shutil.rmtree(final + ".old", ignore_errors=True)
        else:
            with_retries(_rename, tmp, final, **_IO_RETRIES)
    finally:
        with _PENDING_LOCK:
            _ACTIVE_TMP.discard(tmp)
    _retire(ckpt_dir, keep)
    return final


def recover_stale(ckpt_dir: str) -> int:
    """Crash-window recovery on the read path: a save that died between
    the two renames of the replace protocol leaves the only complete
    copy at ``step_N.old`` with ``step_N`` missing; rename it back.
    Returns the number recovered; never deletes anything."""
    if not os.path.isdir(ckpt_dir):
        return 0
    recovered = 0
    for name in os.listdir(ckpt_dir):
        m = _OLD_RE.match(name)
        if not m:
            continue
        path = os.path.join(ckpt_dir, name)
        final = os.path.join(ckpt_dir, f"step_{m.group(1)}")
        if not os.path.exists(final) and os.path.exists(
                os.path.join(path, "manifest.json")):
            with_retries(_rename, path, final, **_IO_RETRIES)
            recovered += 1
    return recovered


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass                       # EPERM etc.: some process owns the pid
    return True


def _retire(ckpt_dir: str, keep: int) -> None:
    """Retention and crash cleanup: retire committed checkpoints beyond
    the newest ``keep``, then sweep ``step_*.tmp-*`` directories whose
    writer is gone (never this process' in-flight saves, never a live
    foreign writer) and ``step_*.old`` leftovers, first renaming an
    ``.old`` back when it is the only complete copy."""
    all_steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            all_steps.append(int(m.group(1)))
    for s in sorted(all_steps)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        m = _OLD_RE.match(name)
        if m:
            final = os.path.join(ckpt_dir, f"step_{m.group(1)}")
            if not os.path.exists(final) and os.path.exists(
                    os.path.join(path, "manifest.json")):
                os.rename(path, final)   # crash between renames: recover
            else:
                shutil.rmtree(path, ignore_errors=True)
            continue
        m = _TMP_RE.match(name)
        if not m:
            continue
        with _PENDING_LOCK:
            if path in _ACTIVE_TMP:
                continue           # this process is mid-save here
        pid = int(m.group(1))
        if pid != os.getpid() and _pid_alive(pid):
            continue               # a live foreign writer owns it
        shutil.rmtree(path, ignore_errors=True)


def _write_logged(*args) -> None:
    """:func:`_write` on a background thread: an error is kept for
    :func:`wait_for_saves` to raise."""
    try:
        _write(*args)
    except BaseException as e:     # noqa: BLE001 — re-raised by the waiter
        with _PENDING_LOCK:
            _ERRORS.append(e)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    keep: int = 3, blocking: bool = True,
                    extra: Optional[Dict[str, Any]] = None,
                    packed_dtype: Optional[str] = PACKED_DTYPE,
                    mesh=None, specs: Optional[Dict[Any, Any]] = None
                    ) -> None:
    """Snapshot ``tree`` (params / optimizer state / any nest of dicts,
    NamedTuples, lists and tensors) at ``step``.

    Packed symmetric leaves are stored as their element-packed words,
    f32 / f64 narrowed to ``packed_dtype`` (default bf16; ``None`` keeps
    the source dtype bit-exactly).  bf16-stored state (a
    ``GramMonitor(out_dtype=torch.bfloat16)`` EMA) round-trips
    bit-exactly either way.

    Every leaf is copied to host memory here.  With ``blocking=False``
    the files are written on a background thread; call
    :func:`wait_for_saves` before exiting.

    With ``mesh`` and ``specs`` (collective: every rank calls it alike)
    ``tree`` is this rank's blocks; the ranks of the first data row
    (the first block of every axis no leaf is split over) gather each
    split leaf, one at a time, to rank 0, which keeps it in host memory
    and writes; the other ranks return at once.
    """
    host_leaves: List[HostLeaf] = []
    packed_meta: Dict[str, Dict[str, Any]] = {}
    copy = not blocking
    flat = _flatten(tree)
    leaf_specs = [None] * len(flat)
    if mesh is not None:
        split = {a for sp in specs.values() for a in _split_axes(sp)}
        if any(mesh.index(a) for a in mesh.shape if a not in split):
            return                  # a replica of the first data row's
        leaf_specs = _leaf_specs(tree, specs)
    for (k, v), spec in zip(flat, leaf_specs):
        if mesh is not None:
            v = _whole(v, spec, mesh)
            if mesh.rank != 0:
                continue
        if _is_packed_leaf(v):
            arr, name = _host_packed(v, packed_dtype, copy)
            packed_meta[k] = _packed_meta(v)
        else:
            arr, name = _host(v, copy)
        host_leaves.append((k, arr, name))
    if mesh is not None and mesh.rank != 0:
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    args = (ckpt_dir, step, host_leaves, keep, extra or {}, packed_meta)
    if blocking:
        _write(*args)
        return
    th = threading.Thread(target=_write_logged, args=args, daemon=True)
    th.start()
    with _PENDING_LOCK:
        _PENDING.append(th)


def wait_for_saves() -> None:
    """Join every background save; raise the first error one met."""
    with _PENDING_LOCK:
        pending, _PENDING[:] = _PENDING[:], []
    for th in pending:
        th.join()
    with _PENDING_LOCK:
        errors, _ERRORS[:] = _ERRORS[:], []
    if errors:
        raise errors[0]


def _manifest_path(ckpt_dir: str, step: Optional[int]) -> Tuple[int, str]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return step, os.path.join(ckpt_dir, f"step_{step:08d}")


def checkpoint_bytes(ckpt_dir: str, step: Optional[int] = None
                     ) -> Dict[str, Any]:
    """Per-leaf and total payload bytes of one checkpoint, from its
    manifest."""
    step, d = _manifest_path(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {k: m.get("bytes", 0) for k, m in manifest["leaves"].items()}
    return {"step": step, "total": sum(leaves.values()), "leaves": leaves}


def read_manifest(ckpt_dir: str, step: Optional[int] = None
                  ) -> Dict[str, Any]:
    """The raw manifest of the newest (or ``step``) checkpoint: leaf
    shapes, dtypes and crcs, each packed leaf's layout, and the saver's
    ``extra``."""
    recover_stale(ckpt_dir)
    _, d = _manifest_path(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def _load_leaf(d: str, key: str, meta: Dict[str, Any]) -> torch.Tensor:
    """One leaf's words as a CPU tensor, its crc checked."""
    with open(os.path.join(d, key + ".npy"), "rb") as f:
        raw = bytearray(os.fstat(f.fileno()).st_size)
        got = f.readinto(raw)
    if got != len(raw) or zlib.crc32(raw) != meta["crc"]:
        raise IOError(f"crc mismatch for {key!r}: torn checkpoint?")
    fmt = np.lib.format
    head = io.BytesIO(bytes(memoryview(raw)[:10 + 65535]))  # a 1.0 header
    if fmt.read_magic(head) != (1, 0):
        raise ValueError(f"{key!r}: not a version 1.0 .npy file")
    shape, fortran, dtype = fmt.read_array_header_1_0(head)
    if fortran:
        raise ValueError(f"{key!r}: Fortran-ordered words")
    offset = head.tell()
    bf16 = dtype.kind == "V"
    if bf16 and meta["dtype"] != "bfloat16":
        raise TypeError(f"{key!r}: stored dtype {meta['dtype']!r}")
    arr = np.frombuffer(raw, dtype=np.int16 if bf16 else dtype,
                        count=int(np.prod(shape, dtype=np.int64)),
                        offset=offset).reshape(shape)
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if bf16 else t


def _device_of(like: Any) -> torch.device:
    if isinstance(like, torch.Tensor):
        return like.device
    if isinstance(like, (PackedTriangle, PackedTriangleSlice)):
        return like.vec.device
    if isinstance(like, TriTiles):
        return like.tiles.device
    if isinstance(like, ShardedTriTiles):
        return like.diag.device
    return torch.device("cpu")


def _packed_into(vec: torch.Tensor, n: int, like: Any):
    """Element-packed words -> the layout ``like`` asks for.  Layout
    parameters come from ``like`` (its ``c`` / ``bm`` may differ from the
    saving run's); ``n`` must match.  A dense ``like`` gets the mirrored
    symmetric matrix."""
    if _is_packed_leaf(like):
        if like.n != n:
            raise ValueError(f"packed leaf dimension mismatch: checkpoint "
                             f"has n={n}, restore target has n={like.n}")
        vec = vec.to(like.dtype)
        if isinstance(like, PackedTriangleSlice):
            return PackedTriangleSlice.from_packed(vec, n, like.parts,
                                                   like.index)
        if isinstance(like, ShardedTriTiles):
            return ShardedTriTiles.from_packed(vec, n, like.c, like.mesh,
                                               like.axis)
        if isinstance(like, TriTiles):
            return TriTiles.from_packed(vec, n, like.bm)
        return PackedTriangle(vec, n)
    want = like.dtype if isinstance(like, torch.Tensor) else vec.dtype
    return unpack_tril(vec.float(), n, diag=True, symmetric=True).to(want)


def restore_checkpoint(ckpt_dir: str, like: Any, *,
                       step: Optional[int] = None, mesh=None,
                       specs: Optional[Dict[Any, Any]] = None
                       ) -> Tuple[int, Any]:
    """Restore the newest (or ``step``) checkpoint into the structure of
    ``like``; each leaf lands on the device of its ``like`` leaf.

    Plain leaves come back in their stored dtype (an int ``like`` leaf
    as int).  Packed manifest leaves rebuild into whatever layout the
    ``like`` leaf asks for (:func:`_packed_into`; a
    :class:`PackedTriangleSlice` its slice); a packed ``like`` also takes
    a legacy dense-stored leaf (its lower triangle).

    With ``mesh`` and ``specs`` (the reference's ``shardings=``),
    ``like`` is this rank's blocks and every rank takes its block of
    each stored leaf under its parameter's spec on ``mesh``, whatever
    layout and device count wrote it."""
    recover_stale(ckpt_dir)
    step, d = _manifest_path(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = []
    flat = _flatten(like)
    leaf_specs = _leaf_specs(like, specs) if mesh is not None \
        else [None] * len(flat)
    for (key, lk), spec in zip(flat, leaf_specs):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _load_leaf(d, key, meta)
        if mesh is not None and not _is_packed_leaf(lk) \
                and not isinstance(lk, int):
            t = _block(t, spec, mesh, _device_of(lk))
        else:
            t = t.to(_device_of(lk))
        if "packed" in meta:
            leaf = _packed_into(t, int(meta["packed"]["n"]), lk)
        elif _is_packed_leaf(lk):
            leaf = _packed_into(pack_tril(t), t.shape[-1], lk)
        elif isinstance(lk, int) and not isinstance(lk, bool):
            leaf = int(t)
        else:
            if isinstance(lk, torch.Tensor) and lk.shape != t.shape:
                raise ValueError(f"{key!r}: checkpoint shape "
                                 f"{tuple(t.shape)}, restore target "
                                 f"{tuple(lk.shape)}")
            leaf = t
        loaded.append(leaf)
    return step, _unflatten(like, iter(loaded))


def verify_restored(ckpt_dir: str, tree: Any, *,
                    step: Optional[int] = None, mesh=None,
                    specs: Optional[Dict[Any, Any]] = None
                    ) -> Dict[str, Any]:
    """Prove a restore round-tripped bit-exactly: re-encode every leaf
    of ``tree`` as :func:`save_checkpoint` did (packed leaves in their
    stored dtype from the manifest) and compare its crc32 with the
    manifest's.  Returns ``{"checked", "packed", "mismatches"}``.

    With ``mesh`` and ``specs`` (collective: every rank calls it alike)
    ``tree`` is this rank's blocks as placed: each split leaf is
    gathered back over its axes, one at a time, to the rank holding the
    first block of each (every data row's own), which checks the whole
    leaf; every rank checks the leaves it holds whole.  A rank's counts
    cover the leaves it checked."""
    manifest = read_manifest(ckpt_dir, step)
    checked = packed = 0
    mismatches: List[str] = []
    flat = _flatten(tree)
    leaf_specs = _leaf_specs(tree, specs) if mesh is not None \
        else [None] * len(flat)
    for (k, v), spec in zip(flat, leaf_specs):
        if mesh is not None:
            v = _whole(v, spec, mesh)
            if v is None:               # checked on its axes' first rank
                continue
        meta = manifest["leaves"].get(k)
        if meta is None:
            mismatches.append(k)
            continue
        if _is_packed_leaf(v):
            vec = _packed_vec(v).to(_torch_dtype(meta["dtype"]))
            arr, name = _host(vec, copy=False)
            packed += 1
        else:
            arr, name = _host(v, copy=False)
        checked += 1
        if _npy_crc(arr, name) != meta["crc"]:
            mismatches.append(k)
    return {"checked": checked, "packed": packed,
            "mismatches": mismatches}
