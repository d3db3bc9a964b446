"""Runtime supporter (paper §1, §3.2): serve compiled artifacts end to end.

DNNVM is "an integration of optimizers ..., an assembler, a runtime supporter
and a validation environment"; this package is the runtime supporter — the
host-side layer that feeds the accelerator:

* :class:`Session`         — owns one compiled model (artifact via PlanCache,
                             executor on one ``torch.device``, memory
                             plan); ``run`` / ``run_batch``.
* :class:`DynamicBatcher`  — async request queue with max-batch / max-latency
                             knobs; one worker flushes queued images as one
                             batched launch.
* :class:`Server`          — Session + batcher + latency/batch metrics.
* :class:`MultiServer`     — many models on one device: DDR partitioning,
                             per-tenant SLO classes, admission control.
* :class:`Fleet`           — N data-parallel Session replicas across the
                             CUDA devices: health-driven failover,
                             bounded retries, elastic re-admission.
* :class:`ChaosInjector`   — deterministic fault injection (kill / poison /
                             hang / slow) on fleet replicas.
* :func:`pipeline_report`  — engine-level cross-request schedule: the
                             artifact's addressed instruction stream,
                             software-pipelined across requests on the time
                             wheel of the planning device model (ZU2's
                             simulated cycles, not the card's time) and
                             audited by the memory-hazard oracle.
"""
from repro_torch.runtime.batching import BatcherClosed, DynamicBatcher
from repro_torch.runtime.chaos import ChaosError, ChaosInjector
from repro_torch.runtime.fleet import (DeadlineExceeded, Fleet, FleetError,
                                       RetriesExhausted)
from repro_torch.runtime.multitenant import (SLO_CLASSES, AdmissionError,
                                             MultiServer)
from repro_torch.runtime.schedule import (PipelineReport, pipeline_report,
                                          pipeline_stream)
from repro_torch.runtime.server import Server
from repro_torch.runtime.session import Session

__all__ = ["AdmissionError", "BatcherClosed", "ChaosError", "ChaosInjector",
           "DeadlineExceeded", "DynamicBatcher", "Fleet", "FleetError",
           "MultiServer", "PipelineReport", "RetriesExhausted", "SLO_CLASSES",
           "Server", "Session", "pipeline_report", "pipeline_stream"]
