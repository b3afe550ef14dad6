"""PISCO core: topologies, schedules, mixing, compression, the PISCO round,
the paper's baselines, the round drivers and the experiment API, under the
reference's names (``repro.core``).  Byzantine agents and robust server
rules are in :mod:`repro_torch.core.adversary`."""
from repro_torch.core.algorithms import (
    Algorithm,
    BoundAlgorithm,
    CommProfile,
    get_algorithm,
    register_algorithm,
    registered_algorithms,
    unregister_algorithm,
)
from repro_torch.core.baselines import GTState, ScaffoldState, SGDState
from repro_torch.core.compression import (
    CompressedGossip,
    Compressor,
    IdentityCompressor,
    StochasticQuantizer,
    TopKCompressor,
    compress_mixing,
    make_byte_model,
    make_compressor,
    message_bytes,
)
from repro_torch.core.driver import drive_loop, drive_scan
from repro_torch.core.experiment import Experiment, ExperimentSpec, run_experiment
from repro_torch.core.mixing import (
    MixingOps,
    NetworkContext,
    collective_dense_mixing,
    collective_global_mixing,
    collective_shift_mixing,
    dense_mixing,
    dynamic_dense_mixing,
    dynamic_sparse_mixing,
    hierarchical_mixing,
    identity_mixing,
    make_network_mixing,
    make_sparse_network_mixing,
    sparse_mixing,
)
from repro_torch.core.pisco import (
    PiscoConfig,
    PiscoState,
    RoundMetrics,
    decentralized_config,
    federated_config,
    init_compression_state,
    init_state,
    make_round_fn,
    make_stacked_value_and_grad,
    replicate_params,
)
from repro_torch.core.schedule import (
    BernoulliSchedule,
    CommAccountant,
    PeriodicSchedule,
    RoundByteModel,
    make_schedule,
)
from repro_torch.core.topology import (
    LinkFailureProcess,
    NeighborSampleProcess,
    ParticipationProcess,
    RandomMatchingProcess,
    RoundRobinProcess,
    SparseTopology,
    StaticProcess,
    Topology,
    TopologyProcess,
    edge_list,
    expected_mixing_rate,
    global_matrix,
    is_connected,
    is_doubly_stochastic,
    make_sparse_topology,
    make_topology,
    make_topology_process,
    metropolis_edge_weights,
    mixing_rate,
    parse_process_spec,
    topology_edges,
    use_sparse_topology,
)
from repro_torch.core.trainer import History, record_wall_time

__all__ = [
    # algorithms
    "Algorithm", "BoundAlgorithm", "CommProfile", "get_algorithm", "register_algorithm",
    "registered_algorithms", "unregister_algorithm", "GTState", "SGDState", "ScaffoldState",
    # drivers and the experiment API
    "drive_loop", "drive_scan", "Experiment", "ExperimentSpec", "run_experiment",
    # the PISCO round
    "PiscoConfig", "PiscoState", "RoundMetrics", "init_state", "init_compression_state",
    "make_round_fn", "make_stacked_value_and_grad", "replicate_params",
    "decentralized_config", "federated_config",
    # topologies and network processes
    "Topology", "TopologyProcess", "StaticProcess", "LinkFailureProcess",
    "RandomMatchingProcess", "RoundRobinProcess", "ParticipationProcess", "make_topology",
    "make_topology_process", "parse_process_spec", "mixing_rate", "expected_mixing_rate",
    "is_doubly_stochastic", "is_connected", "global_matrix", "edge_list", "SparseTopology",
    "NeighborSampleProcess", "topology_edges", "make_sparse_topology",
    "metropolis_edge_weights", "use_sparse_topology",
    # mixing
    "MixingOps", "NetworkContext", "dense_mixing", "dynamic_dense_mixing",
    "make_network_mixing", "identity_mixing", "collective_global_mixing",
    "collective_shift_mixing", "collective_dense_mixing", "hierarchical_mixing",
    "sparse_mixing", "dynamic_sparse_mixing", "make_sparse_network_mixing",
    # schedules, accounting, compression
    "BernoulliSchedule", "PeriodicSchedule", "CommAccountant", "RoundByteModel",
    "make_schedule", "Compressor", "IdentityCompressor", "StochasticQuantizer",
    "TopKCompressor", "CompressedGossip", "compress_mixing", "make_compressor",
    "make_byte_model", "message_bytes",
    # history
    "History", "record_wall_time",
]
