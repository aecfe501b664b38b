from .admm import (
    OuterStages,
    ProblemConsts,
    Solver,
    SolverDiverged,
    SolverState,
    StepAux,
    build_step,
    init_state,
    make_consts,
    solve,
)
from .batch import (
    BatchedSolver,
    SeedEnsembleSolver,
    build_lockstep_step,
    stack_consts,
    stack_states,
)
from .dip import FIT_CHUNK, DipFit, DipResult, get_dip_out, make_dip_fit
from .early_stop import EarlyStopState, init_early_stop, reset_early_stop, update_early_stop
from .scan import ScannedSolve
from .fit import FitConfig, FitResult, find_best_update, fit
from .tiled import solve_tiled

__all__ = [
    "BatchedSolver",
    "DipFit",
    "DipResult",
    "EarlyStopState",
    "FIT_CHUNK",
    "FitConfig",
    "FitResult",
    "OuterStages",
    "ProblemConsts",
    "ScannedSolve",
    "SeedEnsembleSolver",
    "Solver",
    "SolverDiverged",
    "SolverState",
    "StepAux",
    "build_lockstep_step",
    "build_step",
    "find_best_update",
    "fit",
    "get_dip_out",
    "init_early_stop",
    "init_state",
    "make_consts",
    "make_dip_fit",
    "reset_early_stop",
    "solve",
    "solve_tiled",
    "stack_consts",
    "stack_states",
    "update_early_stop",
]
