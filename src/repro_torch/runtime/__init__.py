"""Runtime supporter (paper §1, §3.2): serve a compiled model end to end.

* :class:`Session`        — owns one compiled model (lowered program and
                            executor on one ``torch.device``);
                            ``run`` / ``run_batch``.
* :class:`DynamicBatcher` — async request queue with max-batch /
                            max-latency knobs; one worker flushes queued
                            images as one batched launch.
* :class:`Server`         — Session + batcher + latency/batch metrics.
* :func:`pipeline_report` — engine-level cross-request schedule: the
                            artifact's addressed instruction stream,
                            software-pipelined across requests on the time
                            wheel of the planning device model (ZU2's
                            simulated cycles, not the card's time) and
                            audited by the memory-hazard oracle.
"""
from repro_torch.runtime.batching import BatcherClosed, DynamicBatcher
from repro_torch.runtime.schedule import (PipelineReport, pipeline_report,
                                          pipeline_stream)
from repro_torch.runtime.server import Server
from repro_torch.runtime.session import Session

__all__ = ["BatcherClosed", "DynamicBatcher", "PipelineReport", "Server",
           "Session", "pipeline_report", "pipeline_stream"]
