"""PISCO core: topologies, schedules, mixing, compression, the PISCO round,
the round drivers and the experiment API."""
from repro_torch.core.experiment import Experiment, ExperimentSpec
from repro_torch.core.pisco import PiscoConfig, PiscoState
from repro_torch.core.trainer import History

__all__ = ["Experiment", "ExperimentSpec", "History", "PiscoConfig", "PiscoState"]
