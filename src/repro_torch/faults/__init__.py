"""repro_torch.faults: deterministic fault injection + the farm's hardening
(the PyTorch port's own copy of `repro.faults`, which it may not import).

A seeded `FaultPlan` names injection sites on the filesystem/process
seams the run-farm and the Study executor already use
(`repro_torch.faults.fs` shims — no monkeypatching), so the same schedule
replays exactly; the wire format (`REPRO_FAULTS`) and the seeded decision
sequence are the reference's, so one schedule replays on either fleet. The
`repro_torch.farm chaos` subcommand drives three CI-gated schedules
(worker-kills, torn-writes, lease-storms) and requires the resulting
frames to be bit-identical to a fault-free local `Study.run()` — the
at-least-once + idempotent-fold claim, machine-checked.
"""
from .plan import (FAULT_KINDS, FaultPlan, FaultRule, InjectedCrash,
                   active_plan, deactivate, install)
from .retry import backoff_delays, with_retries
from .schedules import CHAOS_SCHEDULES, chaos_schedule

__all__ = ["CHAOS_SCHEDULES", "FAULT_KINDS", "FaultPlan", "FaultRule",
           "InjectedCrash", "active_plan", "backoff_delays",
           "chaos_schedule", "deactivate", "install", "with_retries"]
