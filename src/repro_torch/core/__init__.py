"""Core library of the port: quantizers, Gram engine, estimators, MWST,
trees and samplers (the paper's main path), the streaming accumulator,
the single-device trial plane (sweeps, faults, bounds), the sparse plane
(glasso, regularization paths) and the single-device channel plane (MAC
superposition, bit-budget rates)."""
# the channel plan values, re-exported beside Strategy as repro.core does
from repro_torch.comm.channel import (BudgetChannel, Channel,  # noqa: F401
                                      GatherChannel, MACChannel)
from . import (bounds, chow_liu, distributed, estimators, experiments,  # noqa: F401
               faults, glasso, gram, path, prng, quantizers, sampler,
               strategy, streaming, trees)
from .chow_liu import (boruvka_mst, boruvka_mst_batch, kruskal_forest,  # noqa: F401
                       kruskal_mst, learn_structure, learn_structure_jit)
from .distributed import CommReport  # noqa: F401
from .experiments import (TrialPlan, TrialResult, evaluate_strategies,  # noqa: F401
                          run_trials,
                          sparse_ground_truth)
from .faults import FaultPlan  # noqa: F401
from .glasso import (glasso as graphical_lasso, glasso_batch,  # noqa: F401
                     learn_sparse_structure)
from .gram import GramConfig, GramEngine, gram_working_set_bytes  # noqa: F401
from .path import PathPlan, glasso_path_batch, glasso_path_select  # noqa: F401
from .quantizers import PerSymbolQuantizer, sign_codes, sign_quantize  # noqa: F401
from .strategy import FIG3_STRATEGIES, Strategy, as_strategy  # noqa: F401
from .streaming import StreamingGram  # noqa: F401
