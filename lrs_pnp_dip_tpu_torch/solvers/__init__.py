from .admm import (
    ProblemConsts,
    Solver,
    SolverDiverged,
    SolverState,
    StepAux,
    build_step,
    init_state,
    make_consts,
)
from .dip import DipResult, make_dip_fit
from .early_stop import EarlyStopState, init_early_stop, update_early_stop

__all__ = [
    "DipResult",
    "EarlyStopState",
    "ProblemConsts",
    "Solver",
    "SolverDiverged",
    "SolverState",
    "StepAux",
    "build_step",
    "init_early_stop",
    "init_state",
    "make_consts",
    "make_dip_fit",
    "update_early_stop",
]
