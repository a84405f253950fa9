"""The model plane: each model generation written once, mapped by every server.

Counterpart of ``predictionio_tpu/streaming/plane.py``; its files are the
JAX package's, byte for byte, so either package composes the other's.

- A publisher (the embedded follower's ``plane_publish``, a ``/reload``, the
  dedicated ``--plane-publisher`` process of a prefork group, or a
  replication subscriber landing a remote publisher's files) writes each
  generation into the plane directory as a PIOARR01 container
  (``store.columnar.write_arrays``: tmp + fsync + rename under a flock'd
  publish lock) and flips ``CURRENT.json``.  The arena holds the derived
  serving state too (the host inverted CSRs, the popularity order, the
  seen-item CSRs), so no reader rebuilds it.
- Readers (:class:`PlaneWatcher`: an inotify wake on Linux, a stat poll
  elsewhere) map the new generation read-only, build a thin ``URModel``
  over the views and install it through the query server's build-ticket
  ``_install``; on the card the install stages the device tables (the
  mapped host views stay shared pages, only the device copies are the
  process's own).
- GC keeps the newest ``PIO_MODEL_PLANE_KEEP`` generations and every older
  file their delta chains reference (chain refcounting); a torn file fails
  validation on map, is renamed ``*.quarantine``, and the old generation
  keeps serving until the publisher heals the chain with a keyframe.

**Delta arenas** (``PIO_MODEL_PLANE_DELTA``, default on): a generation whose
predecessor this publisher wrote holds only what changed, per array the
cheapest faithful encoding: ``ref`` (unchanged: the same object, as the
fold carries it, or equal bytes), ``ext`` (end growth: the suffix),
``patch`` (a few elements), ``nz`` (an LLR table: the values at the valid
cells of the composed idx table), ``inv``/``pop_order`` (replay the fold's
``_patch_inverted_csr``/``_merge_pop_order`` with the changed rows and ids
the fold recorded in ``_plane_prov``) and ``full``.  A reader composes a
delta against the generation it holds, or walks the chain back to the
keyframe (every ``PIO_MODEL_PLANE_FULL_EVERY`` generations).
``PIO_MODEL_PLANE_DELTA=off`` writes full arenas, the bit-exact oracle.

``PIO_MODEL_PLANE=off`` keeps private models; ``on`` forces the plane for
one worker; ``auto`` (default) turns it on for prefork groups.  Only a
bundle of exactly one ``URModel`` rides the plane: anything else raises
:class:`PlaneUnsupported` and the caller serves private models.

Not here: the reference's lineage stages (``plane.write``,
``watcher_wake``, ``compose``), which wait for ROADMAP.md, queue A,
'Observability and the rest of the front end'.
"""

from __future__ import annotations

import json
import logging
import os
import select
import threading
import time
import zlib
from collections.abc import Mapping
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.obs import metrics as _obs_metrics
from predictionio_tpu_torch.store.columnar import CSRLookup, IdDict, read_arrays, write_arrays

log = logging.getLogger("pio.modelplane")

_REG = _obs_metrics.get_registry()
_M_GEN = _REG.gauge(
    "pio_model_plane_generation",
    "Model-plane generation this process serves (a publisher: the one it "
    "last wrote), one {worker} series per process; all equal means the "
    "group has converged")
_M_BYTES = _REG.gauge(
    "pio_model_plane_bytes",
    "On-disk bytes of the plane file this process last mapped or wrote, "
    "one {worker} series: a keyframe is the model's size, a delta the "
    "generation's changed bytes")
_M_MAP_S = _REG.gauge(
    "pio_model_plane_map_seconds",
    "Wall seconds this process spent mapping, composing and installing its "
    "last plane generation (the serving bundle's warm, device staging "
    "included), one {worker} series")
_M_GC = _REG.counter(
    "pio_model_plane_gc_total",
    "Plane files unlinked by a publisher's GC: generations older than every "
    "kept generation's delta chain, quarantined files past it, abandoned "
    "tmp files")
_M_PUB_BYTES = _REG.counter(
    "pio_model_plane_publish_bytes_total",
    "Logical model bytes a publish handled, by path: full (written whole), "
    "delta (written by a delta encoding), ref (not written: referenced, "
    "extended over, patched over or replayed).  (full + delta) / all is "
    "the write amplification")
_M_BLOBS = _REG.gauge(
    "pio_model_plane_blob_count",
    "Generation files a publisher's GC retained (the kept window and the "
    "chain files it references), one {worker} series")
_M_CHAIN = _REG.gauge(
    "pio_model_plane_chain_len",
    "Delta generations between the newest published generation and its "
    "keyframe: the compose depth a cold reader pays, one {worker} series")

_CURRENT = "CURRENT.json"
_LOCK = "plane.lock"
#: stamped by a replication subscriber on every manifest it lands (the
#: publisher it replicates from).  A local publisher finding it publishes
#: keyframes only; a subscriber finding a manifest without it refuses the
#: directory (a local publisher owns it): the split-brain rule.
REPLICA_KEY = "replicatedFrom"


class PlaneUnsupported(RuntimeError):
    """The bundle is not exactly one ``URModel``: the caller serves private
    models."""


class _PlaneCorrupt(ValueError):
    """Deterministic corruption in one plane file; ``fname`` is the file
    that failed (a delta can fail on an earlier file of its chain)."""

    def __init__(self, fname: str, msg: str):
        super().__init__(msg)
        self.fname = fname


def plane_mode() -> str:
    """``PIO_MODEL_PLANE``: on | off | auto (default)."""
    conf = os.environ.get("PIO_MODEL_PLANE", "").lower()
    if conf in ("off", "0", "false"):
        return "off"
    if conf in ("on", "1", "true"):
        return "on"
    return "auto"


def plane_wanted(workers: int) -> bool:
    """auto turns the plane on where private copies multiply, prefork
    groups; on forces it for one worker too."""
    mode = plane_mode()
    return mode == "on" or (mode == "auto" and workers > 1)


def plane_poll_s() -> float:
    """``PIO_MODEL_PLANE_POLL_S`` (default 0.2): the watcher's stat-poll
    period without inotify, its heartbeat with it."""
    try:
        return max(float(os.environ.get("PIO_MODEL_PLANE_POLL_S", "0.2")), 0.02)
    except ValueError:
        return 0.2


def plane_keep() -> int:
    """``PIO_MODEL_PLANE_KEEP`` (default 3): the newest generations GC
    keeps, each with its chain back to its keyframe."""
    try:
        return max(int(os.environ.get("PIO_MODEL_PLANE_KEEP", "3")), 1)
    except ValueError:
        return 3


def plane_delta_enabled() -> bool:
    """``PIO_MODEL_PLANE_DELTA=off`` writes a full arena every generation
    (the bit-exact oracle)."""
    return os.environ.get("PIO_MODEL_PLANE_DELTA", "").lower() not in ("off", "0", "false")


def plane_full_every() -> int:
    """``PIO_MODEL_PLANE_FULL_EVERY`` (default 16): a keyframe every N
    generations bounds the chain a cold reader composes."""
    try:
        return max(int(os.environ.get("PIO_MODEL_PLANE_FULL_EVERY", "16")), 1)
    except ValueError:
        return 16


def plane_notify_enabled() -> bool:
    """``PIO_MODEL_PLANE_NOTIFY=off`` forces the stat-poll fallback."""
    return os.environ.get("PIO_MODEL_PLANE_NOTIFY", "").lower() not in ("off", "0", "false")


def resolve_plane_dir(storage, engine_id: str, variant: str) -> Optional[str]:
    """``PIO_MODEL_PLANE_DIR`` if set, else ``model_plane/<engine>-<variant>``
    under a localfs METADATA path; None elsewhere.  A sharedfs METADATA
    store does not resolve: mmap, flock and unlink-while-mapped hold on one
    node's kernel only, so a multi-node deployment replicates the plane
    (``deploy --plane-publish`` / ``--plane-from``) into node-local dirs."""
    env = os.environ.get("PIO_MODEL_PLANE_DIR")
    if env:
        return env
    try:
        src = storage.config.sources[storage.config.repositories["METADATA"]]
    except (KeyError, AttributeError):
        return None
    if src.get("type") == "sharedfs":
        log.warning("model plane: a sharedfs METADATA store cannot host the plane; for "
                    "multi-node serving publish with `pio deploy --plane-publish PORT` and "
                    "subscribe with `--plane-from HOST:PORT` (or `pio plane-subscribe`), "
                    "each against a node-local PIO_MODEL_PLANE_DIR")
        return None
    if src.get("type") != "localfs" or not src.get("path"):
        return None
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in f"{engine_id}-{variant}")
    return str(Path(src["path"]) / "model_plane" / safe)


class _LazyProps(Mapping):
    """``item_properties`` over the arena's JSON blob, parsed on first
    access (a reader whose rules carried never pays it)."""

    __slots__ = ("_raw", "_doc")

    def __init__(self, raw):
        # an ndarray, or a thunk returning one (the composed props blob)
        self._raw = raw
        self._doc: Optional[dict] = None

    def _load(self) -> dict:
        if self._doc is None:
            raw = self._raw() if callable(self._raw) else self._raw
            self._doc = {} if raw is None or len(raw) == 0 else json.loads(bytes(raw))
            self._raw = None
        return self._doc

    def __getitem__(self, key):
        return self._load()[key]

    def __iter__(self):
        return iter(self._load())

    def __len__(self):
        return len(self._load())


def _json_info(info: Optional[Dict]) -> Dict:
    """The JSON-safe part of a publish info dict."""
    return {k: v for k, v in (info or {}).items()
            if isinstance(v, (str, int, float, bool, type(None)))}


def _flat_u8(arr: np.ndarray) -> np.ndarray:
    return arr.reshape(-1).view(np.uint8)


def _freeze(arr: np.ndarray) -> np.ndarray:
    """Read-only, as the mapped views are."""
    if arr.flags.writeable:
        arr.flags.writeable = False
    return arr


class _ComposedGen(Mapping):
    """One composed generation: name → array, the dictionary blobs and the
    props JSON kept lazy as self-contained ``(dtype, shape, [byte parts])``
    (raw mapped views, never an earlier ``_ComposedGen``, so a chain does
    not pin every intermediate generation).  ``suffix_of`` is this
    generation's ``ext`` suffix: the dictionary extension decodes only it."""

    __slots__ = ("_arrays", "_parts", "_suffixes")

    def __init__(self):
        self._arrays: Dict[str, np.ndarray] = {}
        self._parts: Dict[str, Tuple[str, Tuple[int, ...], List[np.ndarray]]] = {}
        self._suffixes: Dict[str, Tuple[np.ndarray, int]] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        arr = self._arrays.get(name)
        if arr is None:
            dt, shape, parts = self._parts.pop(name)
            flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
            arr = _freeze(flat.view(np.dtype(dt)).reshape(shape))
            self._arrays[name] = arr
        return arr

    def parts_of(self, name: str):
        """The byte-parts descriptor (a materialized array is one part)."""
        got = self._parts.get(name)
        if got is not None:
            return got
        arr = self._arrays[name]
        return (arr.dtype.str, tuple(arr.shape), [_flat_u8(np.ascontiguousarray(arr))])

    def get(self, name: str, default=None):
        if name in self._arrays or name in self._parts:
            return self[name]
        return default

    def __contains__(self, name: str) -> bool:
        return name in self._arrays or name in self._parts

    def __iter__(self):
        yield from self._arrays
        for n in self._parts:
            if n not in self._arrays:
                yield n

    def __len__(self):
        return len(set(self._arrays) | set(self._parts))

    def suffix_of(self, name: str) -> Optional[Tuple[np.ndarray, int]]:
        return self._suffixes.get(name)


def _lazy_name(name: str) -> bool:
    return name.startswith("dict_") or name == "props_json"


class ModelPlane:
    """One plane directory: the publisher side (``publish``) and the reader
    side (``load``), safe to host in one process (the caches are per
    instance, the publish lock is a cross-process flock).  ``device`` is
    where ``load``'s models serve (default ``"cuda"``, resolved only when
    a model is built: a publisher or a subscriber never touches it)."""

    def __init__(self, directory: str, device="cuda"):
        self.dir = str(directory)
        self.device = device
        # publisher: dictionary and props blobs cached by OBJECT (the fold
        # carries unchanged ones by object, so their arrays keep their
        # identity and the delta refs them); the last generation this
        # instance wrote (arrays, model, chain) for the next delta
        self._pub_dicts: Dict[str, Dict[str, Any]] = {}
        self._pub_props: Optional[Tuple[Any, np.ndarray, int]] = None
        self._pub_prev: Optional[Dict[str, Any]] = None
        self._gc_keyframes: Dict[int, int] = {}   # generation -> its keyframe
        self._warned_replica = False
        # reader: dictionaries by content crc (carried, or extended where
        # the publisher proved a byte prefix), the previous model (rule and
        # property caches carry), the composed state the chain patches
        self._dict_cache: Dict[str, Tuple[int, IdDict]] = {}
        self._prev_model = None
        self._prev_meta: Optional[Dict] = None
        self._composed: Optional[_ComposedGen] = None
        self._composed_gen = 0
        self._inv_perms: Dict[int, Dict[str, Any]] = {}
        self._mapped: Dict[str, Tuple[Dict[str, np.ndarray], Dict]] = {}
        self.dicts_extended = 0
        self.dicts_rebuilt = 0
        self.last_publish_stats: Dict[str, int] = {}

    # -- manifest ------------------------------------------------------------

    @property
    def current_path(self) -> str:
        return os.path.join(self.dir, _CURRENT)

    def current(self) -> Optional[Dict]:
        """The live manifest, or None (none yet; the write is an atomic
        rename, so unreadable means absent)."""
        try:
            with open(self.current_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(doc, dict) or "generation" not in doc or "file" not in doc:
            return None
        return doc

    @contextmanager
    def _publish_lock(self):
        import fcntl

        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, _LOCK), "a+") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)

    # -- publisher side ------------------------------------------------------

    def publish(self, models, info: Optional[Dict] = None) -> int:
        """Write one generation; returns its plane generation (the
        ``FollowTrainer.on_publish`` signature).  A delta when this instance
        wrote the predecessor, its chain is intact and no keyframe is due;
        else a full arena.  Raises :class:`PlaneUnsupported` for a bundle
        that is not one ``URModel``; OSError/ValueError propagate (the
        follower's publish retry owns transient failures)."""
        from predictionio_tpu_torch.models.universal_recommender.engine import URModel

        if not (isinstance(models, (list, tuple)) and len(models) == 1
                and type(models[0]) is URModel):
            raise PlaneUnsupported(
                "the model plane serializes exactly one URModel; got "
                f"{[type(m).__name__ for m in (models or [])]}")
        model = models[0]
        # the one derived-state build (or the fold's patch) per node
        model.ensure_host_serving_state()
        arrays, meta = self._model_payload(model)
        meta["info"] = _json_info(info)
        logical = sum(int(np.asarray(a).nbytes) for a in arrays.values())
        # a restage or retrain rebuilt the model: a keyframe, not a delta
        rebuilt = (info or {}).get("mode") in ("restage", "retrain")
        with self._publish_lock():
            cur = self.current()
            gen = int(cur["generation"]) + 1 if cur else 1
            prev = self._pub_prev
            if cur is not None and REPLICA_KEY in cur and not self._warned_replica:
                self._warned_replica = True
                log.warning(
                    "model plane: publishing into a directory fed by plane replication "
                    "(%s=%s): split-brain; run a local publisher or a subscriber against "
                    "%s, not both.  Publishing keyframes only.",
                    REPLICA_KEY, cur.get(REPLICA_KEY), self.dir)
            delta = None
            if (plane_delta_enabled() and not rebuilt and prev is not None
                    and cur is not None and REPLICA_KEY not in cur
                    and int(cur["generation"]) == prev["gen"]
                    and gen - prev["keyframe_gen"] < plane_full_every()
                    and self._chain_intact(prev)):
                delta = self._encode_delta(arrays, model, prev)
            meta["generation"] = gen
            sprov_blobs = self._serve_prov_payload(model, meta, cur, prev, rebuilt)
            if delta is not None:
                entries, blobs, stats = delta
                meta["planeKind"] = "delta"
                meta["prevGeneration"] = prev["gen"]
                meta["prevFile"] = prev["file"]
                meta["manifest"] = entries
                keyframe_gen = prev["keyframe_gen"]
                meta["keyframeGeneration"] = keyframe_gen
                fname = f"gen-{gen:010d}.delta"
                payload = blobs
                chain = prev["chain"] + [fname]
            else:
                meta["planeKind"] = "full"
                meta["keyframeGeneration"] = keyframe_gen = gen
                stats = {"full": logical, "delta": 0, "ref": 0}
                fname = f"gen-{gen:010d}.arena"
                payload = arrays
                chain = [fname]
            if sprov_blobs:
                # on the written payload only: _pub_prev["arrays"] must keep
                # the model payload's key set for the next delta
                payload = dict(payload)
                payload.update(sprov_blobs)
            path = os.path.join(self.dir, fname)
            tmp = os.path.join(self.dir, f".{fname}.tmp-{os.getpid()}")
            write_arrays(tmp, payload, meta)
            os.replace(tmp, path)
            size = os.path.getsize(path)
            self._write_manifest({
                "version": 1, "generation": gen, "file": fname,
                "kind": meta["planeKind"], "bytes": size, "logicalBytes": logical,
                "keyframeGeneration": keyframe_gen, "publisherPid": os.getpid(),
                "publishedAt": time.time()})
            self._gc_keyframes[gen] = keyframe_gen
            kept = self._gc(gen)
        self._pub_prev = {"gen": gen, "file": fname, "keyframe_gen": keyframe_gen,
                          "chain": chain, "arrays": dict(arrays), "model": model}
        self.last_publish_stats = dict(stats, written=stats["full"] + stats["delta"],
                                       file=size, logical=logical)
        tag = _obs_metrics.worker_tag()
        for p in ("full", "delta", "ref"):
            if stats.get(p):
                _M_PUB_BYTES.inc(int(stats[p]), path=p)
        _M_GEN.set(gen, worker=tag)
        _M_BYTES.set(size, worker=tag)
        _M_CHAIN.set(gen - keyframe_gen, worker=tag)
        if kept is not None:
            _M_BLOBS.set(kept, worker=tag)
        log.info("model plane: published generation %d (%s, %.1f MB on disk, %.1f MB "
                 "logical; full/delta/ref %.1f/%.2f/%.1f MB)", gen, fname, size / 1e6,
                 logical / 1e6, stats["full"] / 1e6, stats["delta"] / 1e6, stats["ref"] / 1e6)
        return gen

    def _chain_intact(self, prev: Dict[str, Any]) -> bool:
        """Every file of the previous generation's chain still present?  A
        reader may have quarantined one: a delta on top would strand every
        reader, so heal with a keyframe."""
        for fname in prev["chain"]:
            if not os.path.exists(os.path.join(self.dir, fname)):
                log.warning("model plane: chain file %s missing; publishing a keyframe",
                            fname)
                return False
        return True

    def _serve_prov_payload(self, model, meta: Dict, cur, prev,
                            rebuilt: bool) -> Dict[str, np.ndarray]:
        """``meta["serveProv"]`` and its int64 blobs when the fold's
        provenance holds against the generation this instance wrote last
        (the readers' response caches invalidate by it); {} otherwise, and
        readers flush."""
        from predictionio_tpu_torch.serve.response_cache import _swap_provenance

        if rebuilt or prev is None or cur is None or int(cur["generation"]) != prev["gen"]:
            return {}
        sp = _swap_provenance(model, prev["model"])
        if sp is None:
            return {}
        blobs: Dict[str, np.ndarray] = {}
        inv_keys: Dict[str, str] = {}
        for i, name in enumerate(model.indicator_idx):
            key = f"sprov_inv_{i}"
            blobs[key] = np.ascontiguousarray(sp["inv"][name], np.int64)
            inv_keys[name] = key
        blobs["sprov_pop"] = np.ascontiguousarray(sp["pop"], np.int64)
        meta["serveProv"] = {"prev": int(prev["gen"]), "props": int(bool(sp["props_changed"])),
                             "inv": inv_keys, "pop": "sprov_pop"}
        return blobs

    def _encode_delta(self, arrays: Dict[str, np.ndarray], model, prev: Dict[str, Any]):
        """(manifest entries, blobs, byte stats) of one delta generation, or
        None when the schema changed (a keyframe instead)."""
        prev_arrays: Dict[str, np.ndarray] = prev["arrays"]
        if set(arrays) != set(prev_arrays):
            return None
        prov = model.__dict__.get("_plane_prov")
        prov_ok = bool(prov) and prov["prev"]() is prev["model"]
        entries: Dict[str, Dict] = {}
        blobs: Dict[str, np.ndarray] = {}
        stats = {"full": 0, "delta": 0, "ref": 0}

        def put_blob(key: str, arr: np.ndarray) -> None:
            blobs[key] = arr
            stats["delta"] += int(arr.nbytes)

        # 1) replay instructions from the fold's provenance: a patched CSR
        #    or pop order shifts wholesale, its patch arguments are small
        if prov_ok:
            for i, name in enumerate(model.indicator_idx):
                trio = [f"inv_{i}_indptr", f"inv_{i}_rows", f"inv_{i}_w"]
                changed = prov["inv"].get(name)
                if changed is None or any(t not in arrays for t in trio):
                    continue
                if all(arrays[t] is prev_arrays[t] for t in trio):
                    continue   # carried by object: plain refs below
                key = f"instr_inv_{i}"
                put_blob(key, np.asarray(changed, np.int64))
                for t in trio:
                    entries[t] = {"k": "inv", "type": i, "changed": key}
                    stats["ref"] += int(arrays[t].nbytes)
            po = prov.get("pop_order")
            if (po is not None and "pop_order" in arrays
                    and arrays["pop_order"] is not prev_arrays["pop_order"]):
                put_blob("instr_pop_order", np.asarray(po, np.int64))
                entries["pop_order"] = {"k": "pop_order", "changed": "instr_pop_order"}
                stats["ref"] += int(arrays["pop_order"].nbytes)
        # 2) the rest: byte-level delta detection
        for name, arr in arrays.items():
            if name in entries:
                continue
            old = prev_arrays.get(name)
            entries[name] = self._encode_array(
                name, np.ascontiguousarray(arr),
                None if old is None else np.ascontiguousarray(old),
                arrays.get(name.replace("_llr", "_idx")) if name.endswith("_llr") else None,
                put_blob, stats, identical=arr is old)
        return entries, blobs, stats

    def _encode_array(self, name: str, arr: np.ndarray, old: Optional[np.ndarray],
                      mask: Optional[np.ndarray], put_blob, stats, identical: bool) -> Dict:
        nb = int(arr.nbytes)
        if old is not None and old.dtype == arr.dtype and old.shape[1:] == arr.shape[1:]:
            if identical:
                stats["ref"] += nb
                return {"k": "ref"}
            a8, o8 = _flat_u8(arr), _flat_u8(old)
            prefix_eq = False
            if a8.size >= o8.size:
                # one prefix scan decides ref and ext; a 4 KB quick reject
                # spares the changed-everywhere tables the full pass
                head = min(int(o8.size), 4096)
                prefix_eq = bool(np.array_equal(a8[:head], o8[:head])
                                 and np.array_equal(a8[:o8.size], o8))
            if prefix_eq and a8.size == o8.size:
                stats["ref"] += nb
                return {"k": "ref"}
            if prefix_eq:
                put_blob(name, a8[o8.size:].copy())
                stats["ref"] += int(o8.size)
                return {"k": "ext", "suffix": name, "pre": int(o8.size),
                        "shape": list(arr.shape)}
            # nz: an LLR table's values at its idx table's valid cells
            # (every finite score moves a fold, the padding never does)
            if mask is not None and mask.shape == arr.shape:
                invalid = np.ascontiguousarray(mask) < 0
                pad_vals = arr[invalid]
                if len(pad_vals):
                    pad = pad_vals.ravel()[0]
                    if np.all(pad_vals == pad):
                        vals = arr[~invalid]
                        if vals.nbytes + 64 < nb:
                            put_blob(name, vals.copy())
                            stats["ref"] += nb - int(vals.nbytes)
                            return {"k": "nz", "mask": name.replace("_llr", "_idx"),
                                    "pad": float(pad), "shape": list(arr.shape)}
            # a sparse element patch (growth counts as changed elements; a
            # shrunk array writes whole)
            if a8.size >= o8.size:
                it = arr.dtype.itemsize
                n_old = o8.size // it
                flat_a = arr.reshape(-1)
                diff = np.flatnonzero((a8[:o8.size].reshape(-1, it)
                                       != o8.reshape(-1, it)).any(axis=1))
                tail = np.arange(n_old, flat_a.shape[0], dtype=np.int64)
                idx = (np.concatenate([diff.astype(np.int64), tail]) if len(tail)
                       else diff.astype(np.int64))
                patch_bytes = int(idx.nbytes + idx.shape[0] * it)
                if patch_bytes + 64 < nb // 2:
                    put_blob(f"{name}.pidx", idx)
                    put_blob(f"{name}.pval", flat_a[idx].copy())
                    stats["ref"] += nb - patch_bytes
                    return {"k": "patch", "idx": f"{name}.pidx", "vals": f"{name}.pval",
                            "shape": list(arr.shape)}
        put_blob(name, arr)
        stats["delta"] -= nb     # a whole array counts as full
        stats["full"] += nb
        return {"k": "full", "key": name}

    def _write_manifest(self, doc: Dict) -> None:
        tmp = self.current_path + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.current_path)

    def file_meta(self, name: str) -> Optional[Dict]:
        """A plane file's ``meta`` from its JSON header alone (no mapping);
        None when unreadable or torn."""
        try:
            with open(os.path.join(self.dir, name), "rb") as f:
                head = f.read(16)
                if len(head) < 16:
                    return None
                hlen = int.from_bytes(head[8:16], "little")
                if hlen > 64 << 20:
                    return None
                meta = json.loads(f.read(hlen)).get("meta", {})
        except (OSError, ValueError):
            return None
        return meta if isinstance(meta, dict) else None

    def _file_keyframe(self, name: str) -> Optional[int]:
        meta = self.file_meta(name)
        if meta is None:
            return None
        kf = meta.get("keyframeGeneration")
        if kf is not None:
            return int(kf)
        return _gen_of(name) if name.endswith(".arena") else None

    def chain_files(self, fname: str) -> List[str]:
        """``[keyframe .. fname]`` by the headers' ``prevFile`` links (how a
        replicator serves a cold or lagging subscriber).  Raises
        :class:`_PlaneCorrupt` naming the file that breaks the walk."""
        chain = [str(fname)]
        f = str(fname)
        for _ in range(100000):
            meta = self.file_meta(f)
            if meta is None:
                raise _PlaneCorrupt(f, f"{f}: unreadable header in delta-chain walk")
            if (meta.get("planeKind") or "full") != "delta":
                chain.reverse()
                return chain
            pf = meta.get("prevFile")
            if not pf:
                raise _PlaneCorrupt(f, f"{f}: delta with no prevFile")
            f = str(pf)
            chain.append(f)
        raise _PlaneCorrupt(str(fname), f"{fname}: delta chain does not terminate")

    def _gc(self, newest_gen: int) -> Optional[int]:
        """Unlink what no kept generation's chain references: the floor is
        the least keyframe over the newest ``plane_keep()`` generations
        (chains are contiguous runs back to a keyframe), so every file a
        kept manifest needs survives.  Quarantined files under the floor
        and abandoned tmp files go too.  Returns the retained count."""
        keep_min = newest_gen - plane_keep() + 1
        try:
            names = os.listdir(self.dir)
        except OSError:
            return None
        floor = keep_min
        for g in range(keep_min, newest_gen + 1):
            kf = self._gc_keyframes.get(g)
            if kf is None:
                # written before this process started: read its header
                for nm in (f"gen-{g:010d}.delta", f"gen-{g:010d}.arena"):
                    if os.path.exists(os.path.join(self.dir, nm)):
                        kf = self._file_keyframe(nm)
                        break
                self._gc_keyframes[g] = kf if kf is not None else g
                kf = self._gc_keyframes[g]
            floor = min(floor, kf)
        for g in [g for g in self._gc_keyframes if g < floor]:
            del self._gc_keyframes[g]
        now = time.time()
        removed = kept = 0
        for name in names:
            path = os.path.join(self.dir, name)
            if ".tmp-" in name:
                # a killed publisher's partial write, never referenced
                try:
                    if now - os.path.getmtime(path) > 300:
                        os.unlink(path)
                        removed += 1
                except OSError:
                    pass
                continue
            gen = _gen_of(name)
            if gen is None:
                continue
            if gen < floor:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
            elif not name.endswith(".quarantine"):
                kept += 1
        if removed:
            _M_GC.inc(removed)
        return kept

    def _model_payload(self, model) -> Tuple[Dict[str, np.ndarray], Dict]:
        names: List[str] = list(model.indicator_idx)
        bl_names: List[str] = list(model.user_seen_by_event)
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict[str, Any] = {
            "schema": 1, "primaryEvent": model.primary_event, "eventNames": names,
            "blacklistNames": bl_names, "nItems": len(model.item_dict),
            "nUsers": len(model.user_dict), "dicts": {}}
        arrays["popularity"] = np.asarray(model.popularity)
        arrays["pop_order"] = model.host_pop_order()
        arrays["user_seen_indptr"] = model.user_seen.indptr
        arrays["user_seen_values"] = model.user_seen.values
        for j, bname in enumerate(bl_names):
            csr = model.user_seen_by_event[bname]
            arrays[f"seen_{j}_indptr"] = csr.indptr
            arrays[f"seen_{j}_values"] = csr.values
        for i, name in enumerate(names):
            arrays[f"ind_{i}_idx"] = model.indicator_idx[name]
            arrays[f"ind_{i}_llr"] = model.indicator_llr[name]
            indptr, rows, w = model.host_inverted(name)
            arrays[f"inv_{i}_indptr"] = indptr
            arrays[f"inv_{i}_rows"] = rows
            arrays[f"inv_{i}_w"] = w
        meta["dicts"]["item"] = self._encode_dict("item", model.item_dict, arrays)
        meta["dicts"]["user"] = self._encode_dict("user", model.user_dict, arrays)
        for i, name in enumerate(names):
            d = model.event_item_dicts[name]
            meta["dicts"][f"ev_{i}"] = ({"sameAs": "item"} if d is model.item_dict
                                        else self._encode_dict(f"ev_{i}", d, arrays))
        arrays["props_json"], crc = self._encode_props(model.item_properties)
        meta["propsCrc"] = crc
        return arrays, meta

    def _encode_dict(self, slot: str, d: IdDict, arrays: Dict[str, np.ndarray]) -> Dict:
        """A dictionary as a UTF-8 blob and int64 offsets, cached by OBJECT
        (a carried dictionary keeps its arrays, so the delta refs them); a
        changed one whose previous blob is a byte prefix records
        ``prevCrc``/``prevN``, so readers extend theirs by the new strings."""
        cached = self._pub_dicts.get(slot)
        if cached is not None and cached["obj"] is d:
            entry = {"crc": cached["crc"], "n": cached["n"]}
        else:
            strings = d.strings()
            enc = [s.encode("utf-8", "surrogatepass") for s in strings]
            blob = b"".join(enc)
            offs = np.zeros(len(enc) + 1, np.int64)
            if enc:
                np.cumsum([len(b) for b in enc], out=offs[1:])
            crc = int(zlib.crc32(blob))
            entry = {"crc": crc, "n": len(strings)}
            if (cached is not None and entry["n"] >= cached["n"]
                    and len(blob) >= len(cached["blob"])
                    and blob[:len(cached["blob"])] == cached["blob"]):
                entry["prevCrc"] = cached["crc"]
                entry["prevN"] = cached["n"]
            cached = self._pub_dicts[slot] = {
                "obj": d, "blob": blob, "blob_arr": np.frombuffer(blob, np.uint8),
                "offs": offs, "crc": crc, "n": len(strings)}
        arrays[f"dict_{slot}_blob"] = cached["blob_arr"]
        arrays[f"dict_{slot}_offs"] = cached["offs"]
        return entry

    def _encode_props(self, props) -> Tuple[np.ndarray, int]:
        cached = self._pub_props
        if cached is not None and cached[0] is props:
            return cached[1], cached[2]
        blob = json.dumps(dict(props or {}), separators=(",", ":"), sort_keys=True,
                          default=str).encode()
        crc = int(zlib.crc32(blob))
        arr = np.frombuffer(blob, np.uint8)
        self._pub_props = (props, arr, crc)
        return arr, crc

    # -- reader side ---------------------------------------------------------

    def quarantine(self, manifest: Dict, err: Exception) -> None:
        """Rename the failing file ``*.quarantine`` and keep serving; the
        publisher's next write finds the chain broken and heals it."""
        fname = getattr(err, "fname", None) or manifest.get("file")
        log.warning("model plane: generation %s unusable (%s: %s); quarantined %s, "
                    "keeping the served generation", manifest.get("generation"),
                    type(err).__name__, err, fname)
        if not fname:
            return
        path = os.path.join(self.dir, str(fname))
        try:
            os.replace(path, path + ".quarantine")
        except OSError:
            pass
        self._mapped.pop(str(fname), None)

    def _map_file(self, fname: str):
        """(arrays, meta) of one plane file, cached by name."""
        hit = self._mapped.get(fname)
        if hit is not None:
            return hit
        try:
            arrays, meta = read_arrays(os.path.join(self.dir, fname), mmap=True)
        except ValueError as e:
            raise _PlaneCorrupt(fname, str(e)) from e
        self._mapped[fname] = (arrays, meta)
        return arrays, meta

    def load(self, manifest: Dict):
        """Map and compose the manifest's generation → ``(URModel, info)``.

        A keyframe maps directly; a delta composes against the generation
        loaded last, or (cold) walks ``prevFile`` back to the keyframe.
        The derived serving state lands in the model's ``__dict__`` caches;
        dictionaries and property indexes carry where the manifest proves
        them unchanged.  Raises ValueError (:class:`_PlaneCorrupt` with the
        failing file) on torn content, OSError on a transient miss."""
        fname = str(manifest["file"])
        chain: List[Tuple[str, Dict[str, np.ndarray], Dict]] = []
        f = fname
        for _ in range(100000):
            arrays, meta = self._map_file(f)
            chain.append((f, arrays, meta))
            if (meta.get("planeKind") or "full") != "delta":
                break
            pg = int(meta.get("prevGeneration") or 0)
            pf = meta.get("prevFile")
            if self._composed is not None and self._composed_gen == pg:
                break
            if not pf:
                raise _PlaneCorrupt(f, f"{f}: delta with no prevFile")
            f = str(pf)
        else:
            raise _PlaneCorrupt(fname, "delta chain does not terminate")
        chain.reverse()
        composed = self._composed
        inv_perms = dict(self._inv_perms)
        for cf, arrays, meta in chain:
            if (meta.get("planeKind") or "full") != "delta":
                composed = _ComposedGen()
                composed._arrays = dict(arrays)
                inv_perms = {}
            else:
                composed = self._compose_delta(cf, composed, arrays, meta, inv_perms)
        final_meta = chain[-1][2]
        if final_meta.get("schema") != 1:
            raise _PlaneCorrupt(chain[-1][0], f"unknown arena schema {final_meta.get('schema')}")
        model = self._build_model(composed, final_meta)
        gen = int(final_meta.get("generation") or manifest["generation"])
        # the publisher's changed sets, copied out of the mapping, for the
        # response cache (meaningful only against prevGeneration)
        sp = final_meta.get("serveProv")
        if isinstance(sp, dict):
            try:
                raw = chain[-1][1]
                model.__dict__["_serve_prov"] = {
                    "prev_gen": int(sp["prev"]),
                    "props_changed": bool(sp.get("props")),
                    "inv": {str(name): np.array(raw[str(key)], np.int64)
                            for name, key in dict(sp["inv"]).items()},
                    "pop": np.array(raw[str(sp["pop"])], np.int64)}
            except (KeyError, TypeError, ValueError):
                model.__dict__.pop("_serve_prov", None)
        # commit the compose state only after a whole build
        self._composed, self._composed_gen = composed, gen
        self._inv_perms = inv_perms
        live = {cf for cf, _a, _m in chain}
        for stale in [k for k in self._mapped if k not in live]:
            del self._mapped[stale]    # the views keep their mappings alive
        info = dict(final_meta.get("info") or {})
        info["planeGeneration"] = gen
        info["planeBytes"] = int(manifest.get("bytes") or 0)
        return model, info

    def _compose_delta(self, fname: str, prev: Optional[_ComposedGen],
                       arrays: Dict[str, np.ndarray], meta: Dict,
                       inv_perms: Dict[int, Dict[str, Any]]) -> _ComposedGen:
        """One delta's manifest over the previous composed generation: eager
        for the numeric arrays, lazy for the dictionary blobs and props."""
        if prev is None:
            raise _PlaneCorrupt(fname, f"{fname}: delta chain has no base generation")
        manifest: Dict[str, Dict] = meta.get("manifest") or {}
        out = _ComposedGen()
        memo: Dict[str, np.ndarray] = {}
        trio_memo: Dict[int, Tuple] = {}
        resolving: set = set()

        def prev_arr(name: str) -> np.ndarray:
            try:
                return prev[name]
            except KeyError:
                raise _PlaneCorrupt(fname, f"{fname}: base generation lacks {name}")

        def resolve(name: str) -> np.ndarray:
            got = memo.get(name)
            if got is not None:
                return got
            if name in resolving:
                raise _PlaneCorrupt(fname, f"{fname}: manifest cycle at {name}")
            resolving.add(name)
            try:
                entry = manifest.get(name)
                if entry is None:
                    raise _PlaneCorrupt(fname, f"{fname}: manifest lacks {name}")
                arr = self._compose_entry(fname, name, entry, prev_arr, arrays, meta,
                                          resolve, inv_perms, trio_memo)
            finally:
                resolving.discard(name)
            memo[name] = arr
            return arr

        for name, entry in manifest.items():
            k = entry["k"]
            if _lazy_name(name) and k in ("ref", "ext", "full"):
                # lazy and self-contained: byte parts, never the previous
                # composed generation
                try:
                    if k == "full":
                        out._arrays[name] = arrays[entry["key"]]
                    elif name not in prev:
                        raise _PlaneCorrupt(fname, f"{fname}: base generation lacks {name}")
                    elif k == "ref":
                        got = prev._arrays.get(name)
                        if got is not None:
                            out._arrays[name] = got
                        else:
                            out._parts[name] = prev.parts_of(name)
                    else:
                        suffix = arrays[entry["suffix"]]
                        dt, _shape, base = prev.parts_of(name)
                        out._parts[name] = (dt, tuple(entry["shape"]), base + [suffix])
                        out._suffixes[name] = (suffix, int(entry["pre"]))
                except KeyError as e:
                    raise _PlaneCorrupt(fname, f"{fname}: cannot compose {name}: {e}") from e
            else:
                out._arrays[name] = _freeze(resolve(name))
        return out

    def _compose_entry(self, fname: str, name: str, entry: Dict, prev_arr,
                       arrays: Dict[str, np.ndarray], meta: Dict, resolve, inv_perms,
                       trio_memo: Dict[int, Tuple]) -> np.ndarray:
        try:
            k = entry["k"]
            if k == "ref":
                return prev_arr(name)
            if k == "full":
                return arrays[entry["key"]]
            if k == "ext":
                old = prev_arr(name)
                flat = np.concatenate([_flat_u8(np.ascontiguousarray(old)),
                                       arrays[entry["suffix"]]])
                return flat.view(old.dtype).reshape(tuple(entry["shape"]))
            if k == "patch":
                old = prev_arr(name)
                shape = tuple(entry["shape"])
                n = int(np.prod(shape)) if shape else 1
                flat = np.empty(n, old.dtype)
                flat[:old.size] = old.reshape(-1)
                flat[arrays[entry["idx"]]] = arrays[entry["vals"]]
                return flat.reshape(shape)
            if k == "nz":
                mask = resolve(entry["mask"])
                vals = arrays[name]
                out = np.full(mask.shape, entry["pad"], vals.dtype)
                out[mask >= 0] = vals
                return out
            if k == "inv":
                part = name.rsplit("_", 1)[1]
                return self._replay_inv(fname, int(entry["type"]), arrays[entry["changed"]],
                                        prev_arr, resolve, meta, inv_perms, trio_memo)[
                    {"indptr": 0, "rows": 1, "w": 2}[part]]
            if k == "pop_order":
                from predictionio_tpu_torch.streaming.fold import _merge_pop_order

                return _merge_pop_order(prev_arr("pop_order"),
                                        np.asarray(resolve("popularity"), np.float32),
                                        arrays[entry["changed"]])
            raise KeyError(f"unknown entry kind {k!r}")
        except _PlaneCorrupt:
            raise
        except (KeyError, IndexError, ValueError) as e:
            raise _PlaneCorrupt(fname, f"{fname}: cannot compose {name}: "
                                       f"{type(e).__name__}: {e}") from e

    def _replay_inv(self, fname: str, i: int, changed: np.ndarray, prev_arr, resolve,
                    meta: Dict, inv_perms, trio_memo: Dict[int, Tuple]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The fold's inverted-CSR patch of event type ``i`` replayed: the
        same functions on the same arguments (the changed rows of the
        fold's provenance), so the trio is bit-identical to the
        publisher's.  The inversion permutation carries across generations
        keyed to the idx object it was built for, else is recomputed from
        the previous idx table (after a keyframe)."""
        from predictionio_tpu_torch.streaming.fold import _inverted_perm, _patch_inverted_csr

        got = trio_memo.get(i)
        if got is not None:
            return got
        old_indptr = prev_arr(f"inv_{i}_indptr")
        old_rows = prev_arr(f"inv_{i}_rows")
        old_idx = prev_arr(f"ind_{i}_idx")
        new_idx = resolve(f"ind_{i}_idx")
        new_llr = resolve(f"ind_{i}_llr")
        dent = meta["dicts"][f"ev_{i}"]
        if dent.get("sameAs") == "item":
            dent = meta["dicts"]["item"]
        n_t = max(int(dent["n"]), 1)
        cache = inv_perms.get(i)
        perm = (cache["perm"] if cache is not None and cache["for_idx"] is old_idx
                else _inverted_perm(np.asarray(old_idx)))
        changed = np.asarray(changed, np.int64)
        if len(changed) == 0:
            indptr = np.asarray(old_indptr)
            if len(indptr) < n_t + 1:
                indptr = np.concatenate([indptr, np.full(n_t + 1 - len(indptr), indptr[-1],
                                                         np.int64)])
            rows = np.asarray(old_rows)
        else:
            indptr, rows, perm = _patch_inverted_csr(
                np.asarray(old_indptr), np.asarray(old_rows), perm, changed,
                np.asarray(old_idx), np.asarray(new_idx), n_t, int(new_idx.shape[0]))
        w = np.asarray(new_llr).ravel()[perm].astype(np.float32, copy=False)
        inv_perms[i] = {"for_idx": new_idx, "perm": perm}
        trio = (_freeze(np.asarray(indptr)), _freeze(np.asarray(rows)), _freeze(w))
        trio_memo[i] = trio
        return trio

    def _build_model(self, arrays, meta: Dict):
        from predictionio_tpu_torch.models.universal_recommender.engine import URModel

        names = list(meta["eventNames"])
        item_dict = self._restore_dict("item", meta["dicts"]["item"], arrays)
        user_dict = self._restore_dict("user", meta["dicts"]["user"], arrays)
        event_item_dicts: Dict[str, IdDict] = {}
        for i, name in enumerate(names):
            entry = meta["dicts"][f"ev_{i}"]
            event_item_dicts[name] = (item_dict if entry.get("sameAs") == "item"
                                      else self._restore_dict(f"ev_{i}", entry, arrays))
        user_seen_by_event = {
            bname: CSRLookup(arrays[f"seen_{j}_indptr"], arrays[f"seen_{j}_values"])
            for j, bname in enumerate(meta["blacklistNames"])}
        prev, prev_meta = self._prev_model, self._prev_meta
        item_crc = meta["dicts"]["item"]["crc"]
        props_carried = (prev is not None and prev_meta is not None
                         and meta.get("propsCrc") == prev_meta.get("propsCrc")
                         and item_crc == prev_meta["dicts"]["item"]["crc"])
        if props_carried:
            props = prev.item_properties
        elif "props_json" in arrays:
            # the thunk holds the self-contained parts only, never the
            # _ComposedGen (an unparsed props object would pin it)
            dt, shape, parts = arrays.parts_of("props_json")

            def _raw_props(dt=dt, shape=shape, parts=parts):
                flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
                return flat.view(np.dtype(dt)).reshape(shape)
            props = _LazyProps(_raw_props)
        else:
            props = _LazyProps(None)
        model = URModel(
            primary_event=meta["primaryEvent"], item_dict=item_dict, user_dict=user_dict,
            indicator_idx={n: arrays[f"ind_{i}_idx"] for i, n in enumerate(names)},
            indicator_llr={n: arrays[f"ind_{i}_llr"] for i, n in enumerate(names)},
            event_item_dicts=event_item_dicts, popularity=arrays["popularity"],
            item_properties=props,
            user_seen=CSRLookup(arrays["user_seen_indptr"], arrays["user_seen_values"]),
            user_seen_by_event=user_seen_by_event, device=self.device)
        # the derived serving state rode the plane: pre-populate the caches
        model.__dict__["_host_inv"] = {
            n: (arrays[f"inv_{i}_indptr"], arrays[f"inv_{i}_rows"], arrays[f"inv_{i}_w"])
            for i, n in enumerate(names)}
        model.__dict__["_host_pop_order"] = arrays["pop_order"]
        if props_carried:
            # functions of (item_dict, item_properties), both proven unchanged
            for attr in ("_prop_value_index", "_prop_date_array", "_known_prop_names"):
                v = prev.__dict__.get(attr)
                if v is not None:
                    model.__dict__[attr] = v
        if prev is not None:
            # rule masks, value masks and dates carry on the same proof (the
            # device caches only between models on one device)
            model.adopt_rule_caches(prev, carry=props_carried)
            if prev_meta is not None and item_crc == prev_meta["dicts"]["item"]["crc"]:
                z = prev.__dict__.get("_host_zeros")
                if z is not None:   # read-only by contract; same n_items
                    model.__dict__["_host_zeros"] = z
        model.__dict__["_plane_generation"] = int(meta.get("generation", 0))
        self._prev_model, self._prev_meta = model, meta
        return model

    def _restore_dict(self, slot: str, entry: Dict, arrays) -> IdDict:
        crc, n = int(entry["crc"]), int(entry["n"])
        cached = self._dict_cache.get(slot)
        if cached is not None and cached[0] == crc and len(cached[1]) == n:
            return cached[1]
        if (cached is not None and entry.get("prevCrc") == cached[0]
                and entry.get("prevN") == len(cached[1])):
            # our dictionary is a proven byte prefix: extend a clone by the
            # tail strings only
            d = cached[1].clone()
            start = int(entry["prevN"])
            suffix = (arrays.suffix_of(f"dict_{slot}_blob")
                      if isinstance(arrays, _ComposedGen) else None)
            if suffix is not None:
                # the ext suffix IS the tail: decode it with the offsets'
                # suffix, never touching the covered prefix
                tail_blob, base = suffix
                tail = bytes(tail_blob)
                offs_sfx = arrays.suffix_of(f"dict_{slot}_offs")
                if offs_sfx is not None and offs_sfx[0].size == (n - start) * 8:
                    bounds = np.concatenate([[np.int64(base)],
                                             offs_sfx[0].view(np.int64)]) - base
                else:
                    offs = arrays[f"dict_{slot}_offs"]
                    bounds = np.asarray(offs[start:n + 1], np.int64) - base
                for j in range(n - start):
                    d.add(tail[int(bounds[j]):int(bounds[j + 1])]
                          .decode("utf-8", "surrogatepass"))
            else:
                blob = arrays[f"dict_{slot}_blob"]
                offs = arrays[f"dict_{slot}_offs"]
                base = int(offs[start])
                tail = bytes(blob[base:])
                for j in range(start, n):
                    d.add(tail[int(offs[j]) - base:int(offs[j + 1]) - base]
                          .decode("utf-8", "surrogatepass"))
            self.dicts_extended += 1
        else:
            offs = arrays[f"dict_{slot}_offs"]
            raw = bytes(arrays[f"dict_{slot}_blob"])
            d = IdDict.from_state([raw[int(offs[j]):int(offs[j + 1])]
                                   .decode("utf-8", "surrogatepass") for j in range(n)])
            self.dicts_rebuilt += 1
        self._dict_cache[slot] = (crc, d)
        return d


def _gen_of(name: str) -> Optional[int]:
    """The generation in a plane file name (``gen-N.arena``, ``gen-N.delta``,
    either ``.quarantine``); None for other files."""
    if not name.startswith("gen-"):
        return None
    try:
        return int(name[4:14])
    except ValueError:
        return None


class _DirNotify:
    """inotify on the plane directory through ctypes: ``wait`` returns as
    soon as a file lands or is renamed there.  Raises OSError where the
    calls are missing (callers stat-poll)."""

    IN_CLOSE_WRITE = 0x00000008
    IN_CREATE = 0x00000100
    IN_MOVED_TO = 0x00000080

    def __init__(self, directory: str):
        import ctypes
        import ctypes.util

        libc_name = ctypes.util.find_library("c")
        if not libc_name:
            raise OSError("no libc")
        libc = ctypes.CDLL(libc_name, use_errno=True)
        try:
            init1 = libc.inotify_init1
            add_watch = libc.inotify_add_watch
        except AttributeError:
            raise OSError("inotify unavailable")
        self._fd = init1(os.O_NONBLOCK | 0o2000000)   # IN_NONBLOCK | IN_CLOEXEC
        if self._fd < 0:
            raise OSError("inotify_init1 failed")
        wd = add_watch(self._fd, os.fsencode(directory),
                       self.IN_CLOSE_WRITE | self.IN_CREATE | self.IN_MOVED_TO)
        if wd < 0:
            os.close(self._fd)
            raise OSError("inotify_add_watch failed")
        # a self-pipe, so stop() interrupts a wait at once
        self._r, self._w = os.pipe()
        os.set_blocking(self._r, False)
        # poll(), not select(): a busy server's fds can pass FD_SETSIZE
        self._poll = select.poll()
        self._poll.register(self._fd, select.POLLIN)
        self._poll.register(self._r, select.POLLIN)

    def wait(self, timeout: float) -> bool:
        """Block up to ``timeout``; True when a directory event woke us."""
        try:
            ready = self._poll.poll(max(timeout, 0) * 1000)
        except (OSError, ValueError):
            return False
        woke = False
        for fd, _ev in ready:
            try:
                data = os.read(fd, 65536)
            except OSError:
                data = b""
            if fd == self._fd and data:
                woke = True
        return woke

    def poke(self) -> None:
        try:
            os.write(self._w, b"x")
        except OSError:
            pass

    def close(self) -> None:
        for fd in (self._fd, self._r, self._w):
            try:
                os.close(fd)
            except OSError:
                pass


class PlaneWatcher:
    """A server's manifest watcher: installs each new generation through
    ``install(models, info)`` (the query server's build-ticket path).  It
    wakes on inotify where it can, else stat-polls ``CURRENT.json`` every
    ``poll_s`` (opening it only when (ino, mtime, size) moved).
    ``check_now()`` is one synchronous check (``/reload`` and an in-process
    publisher use it so the new generation serves before they answer)."""

    def __init__(self, plane: ModelPlane, install, poll_s: Optional[float] = None):
        self.plane = plane
        self.install = install
        self.poll = poll_s if poll_s is not None else plane_poll_s()
        self.generation = 0
        self._bad_gen = 0
        self._warned_gen = 0
        self._retry = False
        self._stat_sig: Optional[Tuple] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._notify: Optional[_DirNotify] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pio-model-plane-watch")
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._notify is not None:
            self._notify.poke()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._notify is not None:
            self._notify.close()
            self._notify = None

    def _manifest_moved(self) -> bool:
        """Did CURRENT.json's (ino, mtime, size) move since the last probe?
        The first probe always says yes."""
        try:
            st = os.stat(self.plane.current_path)
            sig = (st.st_ino, st.st_mtime_ns, st.st_size)
        except OSError:
            sig = None
        if sig == self._stat_sig:
            return False
        self._stat_sig = sig
        return True

    def _loop(self) -> None:
        if plane_notify_enabled() and self._notify is None:
            try:
                os.makedirs(self.plane.dir, exist_ok=True)
                self._notify = _DirNotify(self.plane.dir)
            except OSError:
                self._notify = None
        while not self._stop.is_set():
            if self._notify is not None:
                self._notify.wait(self.poll)
            elif self._stop.wait(self.poll):
                break
            if self._stop.is_set():
                break
            try:
                # a pending retry bypasses the stat probe (the chain may
                # have healed under an unchanged manifest)
                if self._manifest_moved() or self._retry:
                    self.check_now()
            except Exception:
                log.exception("model-plane watch failed; keeping the served generation")

    def check_now(self) -> bool:
        """One check and install; True when a new generation went live."""
        with self._lock:
            self._retry = False
            cur = self.plane.current()
            if cur is None:
                return False
            gen = int(cur.get("generation") or 0)
            if gen <= self.generation or gen == self._bad_gen:
                return False
            t0 = time.perf_counter()
            try:
                model, info = self.plane.load(cur)
            except (ValueError, KeyError) as e:
                # torn content: quarantine the failing file, remember the
                # generation (no re-probe storm), keep serving
                self._bad_gen = gen
                self.plane.quarantine(cur, e)
                return False
            except OSError as e:
                # transient (EMFILE, a sibling's rename, mid-GC): never
                # quarantine a possibly good file; retry next poll
                self._retry = True
                if self._warned_gen != gen:
                    self._warned_gen = gen
                    log.warning("model plane: could not map generation %s (%s); keeping "
                                "the served generation, will retry", gen, e)
                return False
            installed = self.install([model], info)
            # consumed either way: False means a newer build installed first
            self.generation = gen
            tag = _obs_metrics.worker_tag()
            _M_GEN.set(gen, worker=tag)
            _M_BYTES.set(int(cur.get("bytes") or 0), worker=tag)
            if installed:
                _M_MAP_S.set(time.perf_counter() - t0, worker=tag)
            _obs_metrics.update_process_rss()
            return installed
