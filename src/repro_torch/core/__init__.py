"""Core library of the port: quantizers, Gram engine, estimators, MWST,
trees and samplers (the paper's main path), the streaming accumulator,
and the single-device trial plane (sweeps, faults, bounds)."""
from . import (bounds, chow_liu, distributed, estimators, experiments,  # noqa: F401
               faults, gram, prng, quantizers, sampler, strategy, streaming,
               trees)
from .chow_liu import (boruvka_mst, boruvka_mst_batch, kruskal_forest,  # noqa: F401
                       kruskal_mst, learn_structure, learn_structure_jit)
from .distributed import CommReport  # noqa: F401
from .experiments import TrialPlan, TrialResult, run_trials  # noqa: F401
from .faults import FaultPlan  # noqa: F401
from .gram import GramConfig, GramEngine, gram_working_set_bytes  # noqa: F401
from .quantizers import PerSymbolQuantizer, sign_codes, sign_quantize  # noqa: F401
from .strategy import FIG3_STRATEGIES, Strategy, as_strategy  # noqa: F401
from .streaming import StreamingGram  # noqa: F401
