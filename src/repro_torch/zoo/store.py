# Copied from src/repro/zoo/store.py; imports point at repro_torch.
"""Content-addressed on-disk model zoo for multi-tenant serving.

A production server holds MANY compiled nets (vgg16 + resnet50 + googlenet
at several resolutions); the zoo is where their object files live between
processes.  It generalizes the two persistence idioms the repo already has —
the artifact npz (``asm.save_artifact``) and the on-disk ``tune.ProfileCache``
— into one store:

* **content-addressed**: every artifact is keyed by its ``Compiled`` stage
  hash (graph + quantization + device + strategy signature + profile hash +
  pin_input + artifact format version), so identical compilations share one
  file and a key can never name stale bytes;
* **source-indexed**: each entry also records the *source* fingerprint of
  the pipeline inputs that produced it (``stages.source_key``), so a reopen
  finds the artifact before any search runs;
* **atomic**: npz + sidecar JSON are written to a temp name and
  ``os.replace``d — a crashed writer leaves no half-entry visible;
* **cross-process safe**: writers (put / evict / remove, and get's index
  refresh) serialize on an advisory ``flock`` over ``<root>/.lock``, so
  concurrent processes shelving into one zoo cannot interleave a
  read-modify-write of the sidecar index or evict an entry mid-put;
* **corruption-hardened**: a truncated or garbage npz, or a sidecar whose
  recorded key disagrees with its filename, raises a clear
  :class:`~repro_torch.asm.artifact.ArtifactError` naming the entry — never
  a raw ``zipfile``/``KeyError`` from the reader's guts;
* **bounded**: ``evict`` trims least-recently-*used* entries past
  ``max_entries`` / ``max_bytes`` (both optional), mirroring ``PlanCache``'s
  LRU discipline on disk.

Layout: ``<root>/<key>.npz`` (the object file) + ``<root>/<key>.json`` (the
index record).  Default root: ``$DNNVM_ZOO`` or ``~/.cache/dnnvm/zoo``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

from repro_torch import asm

try:                                    # POSIX advisory locking; the zoo
    import fcntl                        # degrades to in-process-only safety
except ImportError:                     # where it's unavailable
    fcntl = None


def _registry():
    from repro_torch.obs.metrics import REGISTRY
    return REGISTRY


def _events():
    from repro_torch.obs.events import EVENTS
    return EVENTS


class ModelZoo:
    def __init__(self, root: str | None = None, *,
                 max_entries: int | None = None,
                 max_bytes: int | None = None):
        self.root = root or os.environ.get("DNNVM_ZOO") or \
            os.path.join(os.path.expanduser("~"), ".cache", "dnnvm", "zoo")
        self.max_entries = max_entries
        self.max_bytes = max_bytes

    # ------------------------------------------------------------- identity
    @staticmethod
    def key_for(art) -> str:
        """Content address of an artifact (its ``Compiled`` stage hash)."""
        from repro_torch.stages import artifact_stage_keys
        return artifact_stage_keys(art)["compiled"]

    def _npz(self, key: str) -> str:
        return os.path.join(self.root, key + ".npz")

    def _meta(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    # --------------------------------------------------------------- locking
    @contextlib.contextmanager
    def _locked(self):
        """Advisory cross-process writer lock over the whole store
        (``flock`` on ``<root>/.lock``).  NOT re-entrant — internal callers
        already under the lock use the ``_evict``/``_remove`` forms; a second
        ``flock`` on a fresh fd of the same file would deadlock the
        process against itself."""
        os.makedirs(self.root, exist_ok=True)
        if fcntl is None:
            yield
            return
        with open(os.path.join(self.root, ".lock"), "a+") as fh:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh.fileno(), fcntl.LOCK_UN)

    # ---------------------------------------------------------------- write
    def put(self, art, *, name: str | None = None,
            source_key: str | None = None) -> str:
        """Shelve an artifact under its content address (atomic; idempotent —
        re-putting existing content only refreshes the index record;
        concurrent writers serialize on the store lock)."""
        key = self.key_for(art)
        with self._locked():
            npz = self._npz(key)
            fresh = not os.path.exists(npz)
            if fresh:
                tmp = npz + f".tmp-{os.getpid()}"
                try:
                    asm.save_artifact(art, tmp)
                    os.replace(tmp, npz)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            rec = self._read_meta(key) or {
                "key": key, "created": time.time(), "n_opens": 0}
            rec.update({
                "name": name or rec.get("name") or art.meta.get("graph_name"),
                "graph_name": art.meta.get("graph_name"),
                "device": art.device,
                "format_version": asm.artifact.FORMAT_VERSION,
                "profile_hash": art.profile_hash,
                "pin_input": art.pin_input,
                "fused_coverage": art.fused_coverage,
                "peak_ddr_bytes": art.peak_ddr_bytes,
                "size_bytes": os.path.getsize(npz),
                "last_used": time.time(),
            })
            if source_key:
                sources = set(rec.get("source_keys") or [])
                sources.add(source_key)
                rec["source_keys"] = sorted(sources)
            self._write_meta(key, rec)
            _registry().counter("zoo.puts").inc()
            if fresh:
                _events().emit("zoo.put", key=key[:16], model=name,
                               size_bytes=rec["size_bytes"],
                               message=f"shelved {name or key[:16]} "
                                       f"({rec['size_bytes']} B)")
                self._evict()
        return key

    # ----------------------------------------------------------------- read
    def get(self, key: str):
        """Load one artifact by content address (None on a miss; a resident
        but corrupt/tampered entry raises
        :class:`~repro_torch.asm.artifact.ArtifactError` naming the entry)."""
        npz = self._npz(key)
        if not os.path.exists(npz):
            _registry().counter("zoo.misses").inc()
            return None
        rec = self._read_meta(key)
        if rec is not None and rec.get("key") not in (None, key):
            _registry().counter("zoo.corrupt").inc()
            raise asm.ArtifactError(
                f"zoo entry {key!r} under {self.root!r}: sidecar records key "
                f"{rec.get('key')!r} — tampered or misplaced index record")
        try:
            art = asm.load_artifact(npz)
        except FileNotFoundError:        # concurrently evicted between the
            _registry().counter("zoo.misses").inc()   # exists check + read
            return None
        except asm.ArtifactError as e:
            _registry().counter("zoo.corrupt").inc()
            _events().emit("zoo.corrupt", severity="error", key=key[:16],
                           message=f"zoo entry {key[:16]} is corrupt: {e}")
            raise asm.ArtifactError(
                f"zoo entry {key!r} under {self.root!r} is corrupt "
                f"(remove it with ModelZoo.remove): {e}") from e
        with self._locked():
            rec = self._read_meta(key)
            if rec is not None:
                rec["last_used"] = time.time()
                rec["n_opens"] = int(rec.get("n_opens", 0)) + 1
                self._write_meta(key, rec)
        _registry().counter("zoo.hits").inc()
        return art

    def open(self, key: str):
        """Reopen an entry as a ``stages.Compiled`` stage (no recompilation;
        the stage-key chain is rebuilt from the artifact content)."""
        from repro_torch.stages import Compiled
        art = self.get(key)
        if art is None:
            raise KeyError(f"no zoo entry {key!r} under {self.root!r}")
        return Compiled.from_artifact(art)

    def find_source(self, source_key: str):
        """Artifact whose recorded pipeline-input fingerprint matches (None
        when absent) — the reopen-before-search path of
        ``stages.compile_model``."""
        for rec in self.list():
            if source_key in (rec.get("source_keys") or []):
                return self.get(rec["key"])
        _registry().counter("zoo.misses").inc()
        return None

    def list(self) -> list[dict]:
        """Index records of every resident entry, most recently used last."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for fn in sorted(os.listdir(self.root)):
            if not fn.endswith(".json"):
                continue
            key = fn[:-5]
            if not os.path.exists(self._npz(key)):
                continue               # half-evicted: npz gone, sidecar late
            rec = self._read_meta(key)
            if rec is not None:
                out.append(rec)
        return sorted(out, key=lambda r: r.get("last_used", 0.0))

    # ---------------------------------------------------------------- evict
    def remove(self, key: str) -> bool:
        with self._locked():
            return self._remove(key)

    def _remove(self, key: str) -> bool:
        found = False
        for path in (self._npz(key), self._meta(key)):
            if os.path.exists(path):
                os.unlink(path)
                found = True
        return found

    def evict(self, max_entries: int | None = None,
              max_bytes: int | None = None) -> list[str]:
        """Trim least-recently-used entries past the given (or configured)
        bounds; returns the evicted keys."""
        with self._locked():
            return self._evict(max_entries, max_bytes)

    def _evict(self, max_entries: int | None = None,
               max_bytes: int | None = None) -> list[str]:
        max_entries = max_entries if max_entries is not None else \
            self.max_entries
        max_bytes = max_bytes if max_bytes is not None else self.max_bytes
        if max_entries is None and max_bytes is None:
            return []
        recs = self.list()             # LRU first
        total = sum(int(r.get("size_bytes", 0)) for r in recs)
        evicted = []
        while recs and (
                (max_entries is not None and len(recs) > max_entries) or
                (max_bytes is not None and total > max_bytes)):
            victim = recs.pop(0)
            total -= int(victim.get("size_bytes", 0))
            self._remove(victim["key"])
            evicted.append(victim["key"])
            _registry().counter("zoo.evictions").inc()
        if evicted:
            _events().emit("zoo.evict", n=len(evicted),
                           keys=[k[:16] for k in evicted],
                           message=f"zoo evicted {len(evicted)} "
                                   "least-recently-used entr"
                                   f"{'y' if len(evicted) == 1 else 'ies'}")
        return evicted

    # ------------------------------------------------------------ pipelines
    def get_or_compile(self, g, qm, dev, **kw):
        """``stages.compile_model`` against this zoo: reopen when the source
        fingerprint is shelved, compile-and-put otherwise."""
        from repro_torch.stages import compile_model
        return compile_model(g, qm, dev, zoo=self, **kw)

    # ------------------------------------------------------------- sidecars
    def _read_meta(self, key: str) -> dict | None:
        path = self._meta(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None

    def _write_meta(self, key: str, rec: dict) -> None:
        tmp = self._meta(key) + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=2, sort_keys=True)
        os.replace(tmp, self._meta(key))

    def __len__(self) -> int:
        return len(self.list())
