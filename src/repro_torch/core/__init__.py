"""PISCO core: topologies, schedules, mixing, compression, the PISCO round,
the paper's baselines, the round drivers and the experiment API."""
from repro_torch.core.algorithms import get_algorithm, registered_algorithms
from repro_torch.core.baselines import GTState, ScaffoldState, SGDState
from repro_torch.core.experiment import Experiment, ExperimentSpec, run_experiment
from repro_torch.core.pisco import PiscoConfig, PiscoState
from repro_torch.core.trainer import History

__all__ = [
    "Experiment",
    "ExperimentSpec",
    "GTState",
    "History",
    "PiscoConfig",
    "PiscoState",
    "SGDState",
    "ScaffoldState",
    "get_algorithm",
    "registered_algorithms",
    "run_experiment",
]
