"""Fault-tolerance plumbing: heartbeats, straggler detection and the retry
loop (``health``), which the serving fleet wires into its serve loop."""
from repro_torch.distributed.health import (HeartbeatMonitor, HostState,
                                            RetryPolicy, run_with_retries)

__all__ = ["HeartbeatMonitor", "HostState", "RetryPolicy",
           "run_with_retries"]
