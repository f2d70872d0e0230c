"""Core library of the port: quantizers, Gram engine, estimators, MWST,
trees and samplers (the paper's main path), the streaming accumulator,
the trial plane (sweeps, faults, bounds), the sparse plane (glasso,
regularization paths), the channel plane (MAC superposition, bit-budget
rates) and the mesh and wire plane (``WirePlan``, the distributed
pipelines, ``run_trials(mesh=)``)."""
# the channel plan values, re-exported beside Strategy as repro.core does
from repro_torch.comm.channel import (GATHER, BudgetChannel,  # noqa: F401
                                      Channel, GatherChannel, MACChannel)
from . import (bounds, chow_liu, distributed, estimators, experiments,  # noqa: F401
               faults, glasso, gram, path, prng, quantizers, sampler,
               strategy, streaming, trees)
from .chow_liu import (boruvka_mst, boruvka_mst_batch, kruskal_forest,  # noqa: F401
                       kruskal_mst, learn_structure, learn_structure_jit)
from .chow_liu import chow_liu as mwst  # noqa: F401
from .distributed import (CommReport, WirePlan,  # noqa: F401
                          distributed_learn_structure)
from .experiments import (TrialPlan, TrialResult, evaluate_strategies,  # noqa: F401
                          run_trials,
                          sparse_ground_truth)
from .faults import FaultPlan  # noqa: F401
from .glasso import (glasso as graphical_lasso, glasso_batch,  # noqa: F401
                     learn_sparse_structure)
from .gram import (GramConfig, GramEngine, default_engine,  # noqa: F401
                   default_memory_budget, gram_working_set_bytes,
                   set_default_engine)
from .path import PathPlan, glasso_path_batch, glasso_path_select  # noqa: F401
from .quantizers import PerSymbolQuantizer, sign_codes, sign_quantize  # noqa: F401
from .strategy import FIG3_STRATEGIES, Strategy, as_strategy  # noqa: F401
from .streaming import StreamingGram  # noqa: F401
from .trees import (SKELETON_EDGES, chain_tree, random_tree,  # noqa: F401
                    star_tree, tree_correlation_matrix, tree_edit_distance)
