"""Profile-guided autotuning on the card: measure, calibrate, search.

Port of ``src/repro/tune/``.  The paper (§5.1, Table 2) grounds fused-op
costs in on-board measurement and uses the learned model / simulator as
cheaper proxies.  This package does the same for the port's CUDA kernels:

* :mod:`repro_torch.tune.measure`   — harness over lowered ``GroupProgram``
  entries on a ``torch.device`` (CUDA-event device time on the card),
  warm-up / repeats / robust centre, outlier rejection;
* :mod:`repro_torch.tune.profile`   — :class:`DeviceProfile`: fitted
  effective coefficients with versioned JSON (the reference's format) and
  an on-disk cache keyed by (device model, backend, torch and CUDA
  version, GPU name);
* :mod:`repro_torch.tune.calibrate` — least-squares fit of the cost model's
  coefficients against harness measurements, reporting the paper's 5-10%
  deviation band;
* :mod:`repro_torch.tune.evaluator` — :class:`CalibratedEvaluator`, pluggable
  into ``pathsearch.search(evaluator=...)``, over the CUDA kernels' own
  geometry;
* :mod:`repro_torch.tune.tiles`     — the chain kernel's tile search: the
  Eq. 6 feasible (T_h, T_w, T_oc) candidates the card can launch, ranked by
  the profile, the top-K measured, the winners recorded in the strategy.
"""
from repro_torch.tune.calibrate import CalibrationResult, calibrate, fit_profile
from repro_torch.tune.evaluator import CalibratedEvaluator, group_features
from repro_torch.tune.measure import (Measurement, MeasurementHarness,
                                      time_callable)
from repro_torch.tune.profile import (DeviceProfile, ProfileCache,
                                      load_profile, resolve_profile,
                                      save_profile)
from repro_torch.tune.tiles import (TileSearchReport, predict_best_shape,
                                    search_tile_shapes, shape_candidates,
                                    tune_lowered)

__all__ = [
    "CalibrationResult", "calibrate", "fit_profile",
    "CalibratedEvaluator", "group_features",
    "Measurement", "MeasurementHarness", "time_callable",
    "DeviceProfile", "ProfileCache", "load_profile", "save_profile",
    "resolve_profile",
    "TileSearchReport", "predict_best_shape", "search_tile_shapes",
    "shape_candidates", "tune_lowered",
]
