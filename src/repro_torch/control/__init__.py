"""Declarative control plane: FunctionSpec + reconciler over both fleets.

Declare *what* to serve (``FunctionSpec``: profile table, SLO, demand
source); the ``ControlPlane`` reconciles the fleet with paper Alg. 1
through a thin ``Backend`` seam — ``SimBackend`` (discrete-event
simulator) and ``LiveBackend`` (real torch engines) run the same scheduler
code.  See ``src/repro/control/README.md`` for the paper-symbol mapping.
"""

from repro_torch.control.backend import Backend, LiveBackend, SimBackend
from repro_torch.control.plane import (ControlPlane, MigrationEvent,
                                 ReconcileEvent, decision_signature)
from repro_torch.control.spec import (DemandSource, EWMADemand, FunctionSpec,
                                HoltWintersDemand, RPSSource,
                                autocorr_season, fit_holt_winters, ramp)

__all__ = [
    "Backend",
    "ControlPlane",
    "DemandSource",
    "EWMADemand",
    "FunctionSpec",
    "HoltWintersDemand",
    "LiveBackend",
    "MigrationEvent",
    "RPSSource",
    "ReconcileEvent",
    "SimBackend",
    "autocorr_season",
    "decision_signature",
    "fit_holt_winters",
    "ramp",
]
