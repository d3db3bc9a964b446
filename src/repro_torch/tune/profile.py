"""Calibrated device profiles: fitted effective coefficients + on-disk cache.

Port of ``src/repro/tune/profile.py``.  The JSON keeps the reference's field
names and ``hash()`` keeps its inputs, so a profile saved by either package
loads in the other with the same hash.  The ``jax_version`` field keeps its
name for that reason; in the port it holds the torch and CUDA versions
(``torch-2.5.1+cu124-cuda-12.4``, ``cuda-none`` on a CPU build), and
``meta["gpu"]`` the card's name (``cpu`` without one).  Backend names are
``"fused"`` (the reference's ``"pallas"``) and ``"ref"``.

A :class:`DeviceProfile` is what calibration produces and what the
:class:`~repro_torch.tune.evaluator.CalibratedEvaluator` consumes: a small vector of
*measured-world* rates — how fast this (device, backend, toolchain) actually
retires DRAM bytes, conv MACs and pool/misc elements, plus the fixed per-grid-
cell and per-launch overheads that dominate short launches.  The coefficients
are seconds-per-work-unit (see :data:`COEF_NAMES`); their reciprocals are the
effective rates expressed in the ``DeviceModel`` vocabulary (bandwidth,
MACs/cycle, lanes), so a profile can also be projected back onto a
``DeviceModel`` for every consumer of the analytic pipeline model.

Profiles serialize to versioned JSON (:func:`save_profile` /
:func:`load_profile`) and live in an on-disk :class:`ProfileCache` keyed by
(device model, backend, torch and CUDA version, GPU name) — calibrate once
per toolchain and card, reuse
across sessions.  ``DeviceProfile.hash()`` is the stable fingerprint the
compiler records into every ``CompiledArtifact`` planned under the profile.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re

from repro_torch.hw import DeviceModel

PROFILE_SCHEMA_VERSION = 1

# Work-unit vocabulary of the cost model.  A feature vector is aligned with
# this tuple; a profile's ``coef`` holds seconds per unit of each:
#   rd         — DRAM/host bytes read (ifmaps + weights + side inputs)
#   wr         — bytes written (ofmaps)
#   conv       — padded conv MACs
#   pool       — pooling window elements
#   misc       — eltwise/misc elements
#   conv_steps — conv issue steps (in the "kernel" domain of the port: the
#                int8 mma.sync instructions the blocks issue, padding
#                included; see tune.evaluator)
#   pool_steps — pool stage steps (per block and pool stage)
#   misc_steps — eltwise stage steps (per block and eltwise stage)
#   cells      — grid cells (CUDA blocks: per-block staging overhead)
#   launch     — kernel launches (fixed dispatch cost)
COEF_NAMES = ("rd", "wr", "conv", "pool", "misc",
              "conv_steps", "pool_steps", "misc_steps", "cells", "launch")
FEATURE_DOMAINS = ("analytic", "kernel")
COMBINE_FORMS = ("max", "sum")


def _toolchain_version() -> str:
    """What the port records in the ``jax_version`` field: the torch and
    CUDA versions this process runs."""
    import torch
    return f"torch-{torch.__version__}-cuda-{torch.version.cuda or 'none'}"


def _gpu_name() -> str:
    """The card's name (the first CUDA device), or ``cpu`` without one."""
    import torch
    return (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Fitted effective coefficients for one (device, backend, toolchain)."""
    name: str
    device: str                     # base DeviceModel name
    backend: str                    # executor backend measured ("fused"/"ref")
    jax_version: str                # the port: torch and CUDA versions
    features: str                   # feature domain: "analytic" | "kernel"
    combine: str                    # stage combination fitted: "max" | "sum"
    coef: tuple                     # seconds per unit, aligned with COEF_NAMES
    deviation: float                # median |pred-meas|/meas of the fit
    n_samples: int
    schema: int = PROFILE_SCHEMA_VERSION
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.features not in FEATURE_DOMAINS:
            raise ValueError(f"unknown feature domain {self.features!r}")
        if self.combine not in COMBINE_FORMS:
            raise ValueError(f"unknown combine form {self.combine!r}")
        if len(self.coef) != len(COEF_NAMES):
            raise ValueError(f"coef must have {len(COEF_NAMES)} entries")
        object.__setattr__(self, "coef", tuple(float(c) for c in self.coef))

    # ------------------------------------------------------------ identity
    def hash(self) -> str:
        """Stable fingerprint of everything that affects predictions."""
        return _sha({"schema": self.schema, "device": self.device,
                     "backend": self.backend, "features": self.features,
                     "combine": self.combine, "coef": list(self.coef)})

    # ------------------------------------- effective rates (DeviceModel talk)
    def _rate(self, name: str) -> float:
        c = self.coef[COEF_NAMES.index(name)]
        return (1.0 / c) if c > 0 else float("inf")

    @property
    def dram_rd_bytes_per_s(self) -> float:
        return self._rate("rd")

    @property
    def dram_wr_bytes_per_s(self) -> float:
        return self._rate("wr")

    @property
    def conv_macs_per_s(self) -> float:
        return self._rate("conv")

    @property
    def pool_elems_per_s(self) -> float:
        return self._rate("pool")

    @property
    def misc_elems_per_s(self) -> float:
        return self._rate("misc")

    @property
    def launch_overhead_s(self) -> float:
        return self.coef[COEF_NAMES.index("launch")]

    @property
    def cell_overhead_s(self) -> float:
        return self.coef[COEF_NAMES.index("cells")]

    def step_overhead_s(self, engine: str) -> float:
        return self.coef[COEF_NAMES.index(f"{engine}_steps")]

    def effective_summary(self, dev: DeviceModel) -> dict:
        """The fitted coefficients in the device-model vocabulary."""
        f = dev.freq_hz
        fin = (lambda v: v if v != float("inf") else None)
        return {
            "dram_rd_bytes_per_s": fin(self.dram_rd_bytes_per_s),
            "dram_wr_bytes_per_s": fin(self.dram_wr_bytes_per_s),
            "conv_macs_per_cycle": fin(self.conv_macs_per_s / f),
            "pool_lanes": fin(self.pool_elems_per_s / f),
            "misc_lanes": fin(self.misc_elems_per_s / f),
            "conv_step_overhead_us": self.step_overhead_s("conv") * 1e6,
            "pool_step_overhead_us": self.step_overhead_s("pool") * 1e6,
            "misc_step_overhead_us": self.step_overhead_s("misc") * 1e6,
            "launch_overhead_us": self.launch_overhead_s * 1e6,
            "cell_overhead_us": self.cell_overhead_s * 1e6,
        }

    def to_device_model(self, base: DeviceModel) -> DeviceModel:
        """Project the fitted rates onto a ``DeviceModel`` (unfitted or
        unidentifiable coefficients keep the base device's values)."""
        kw = {"name": f"{base.name}+{self.name}"}
        if self.coef[0] > 0:
            kw["dram_bw_bytes_per_s"] = self.dram_rd_bytes_per_s
        if self.coef[2] > 0:
            kw["peak_ops_override"] = 2.0 * self.conv_macs_per_s
        if self.coef[3] > 0:
            kw["pool_lanes"] = max(1, int(self.pool_elems_per_s / base.freq_hz))
        if self.coef[4] > 0:
            kw["misc_lanes"] = max(1, int(self.misc_elems_per_s / base.freq_hz))
        return base.replace(**kw)

    # -------------------------------------------------------- serialization
    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["coef"] = list(self.coef)
        d["hash"] = self.hash()
        return d

    @classmethod
    def from_json(cls, payload: dict) -> "DeviceProfile":
        d = dict(payload)
        recorded = d.pop("hash", None)
        if d.get("schema") != PROFILE_SCHEMA_VERSION:
            raise ValueError(f"profile schema {d.get('schema')} != "
                             f"{PROFILE_SCHEMA_VERSION}")
        p = cls(**d)
        if recorded is not None and recorded != p.hash():
            raise ValueError("profile hash mismatch — corrupted profile JSON")
        return p


def _sha(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True).encode()).hexdigest()[:16]


def save_profile(profile: DeviceProfile, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(profile.to_json(), f, indent=2, sort_keys=True)


def load_profile(path: str) -> DeviceProfile:
    with open(path) as f:
        return DeviceProfile.from_json(json.load(f))


# ---------------------------------------------------------------- disk cache
class ProfileCache:
    """On-disk profile store keyed by (device model, backend, torch and CUDA
    version, GPU name).

    Default root is ``$DNNVM_PROFILE_CACHE`` or ``~/.cache/dnnvm/profiles``;
    one JSON file per key.  A profile without ``meta["gpu"]`` (one saved by
    the reference) is filed under ``unrecorded``.  Calibration writes with :meth:`put`; sessions and
    benchmarks read with :meth:`get` (returns ``None`` on a miss — callers
    decide whether to calibrate or fall back to the analytic model).
    """

    def __init__(self, root: str | None = None):
        self.root = root or os.environ.get("DNNVM_PROFILE_CACHE") or \
            os.path.join(os.path.expanduser("~"), ".cache", "dnnvm", "profiles")

    def key(self, device: str, backend: str, version: str | None = None,
            gpu: str | None = None) -> str:
        raw = (f"{device}--{backend}--{version or _toolchain_version()}"
               f"--{gpu or _gpu_name()}")
        return re.sub(r"[^A-Za-z0-9._-]", "_", raw)

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def get(self, device: str, backend: str, version: str | None = None,
            gpu: str | None = None) -> DeviceProfile | None:
        path = self.path_for(self.key(device, backend, version, gpu))
        if not os.path.exists(path):
            return None
        return load_profile(path)

    def put(self, profile: DeviceProfile) -> str:
        path = self.path_for(self.key(
            profile.device, profile.backend, profile.jax_version,
            profile.meta.get("gpu") or "unrecorded"))
        save_profile(profile, path)
        return path

    def get_by_name(self, name: str) -> DeviceProfile | None:
        if not os.path.isdir(self.root):
            return None
        for fn in sorted(os.listdir(self.root)):
            if not fn.endswith(".json"):
                continue
            try:
                p = load_profile(os.path.join(self.root, fn))
            except (ValueError, json.JSONDecodeError, OSError):
                continue
            if p.name == name:
                return p
        return None


def resolve_profile(profile, cache: ProfileCache | None = None):
    """None | DeviceProfile | name | path -> DeviceProfile | None.

    Strings resolve as a path to a profile JSON when one exists, otherwise as
    a named profile in the (default) on-disk cache."""
    if profile is None or isinstance(profile, DeviceProfile):
        return profile
    if isinstance(profile, str):
        if os.path.exists(profile):
            return load_profile(profile)
        got = (cache or ProfileCache()).get_by_name(profile)
        if got is None:
            raise KeyError(f"no profile named {profile!r} in the cache "
                           f"(root {(cache or ProfileCache()).root!r})")
        return got
    raise TypeError(f"cannot resolve profile from {type(profile).__name__}")
