"""The paper's own experiment configurations (synthetic + skeleton GGMs).

A copy of ``repro.configs.ggm_paper``: these parameterize the
structure-learning experiments of Figs. 3-11 and the production-size run.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GGMConfig:
    name: str
    d: int                    # dimensions == paper machines
    n: int                    # samples
    method: str = "sign"      # sign | persymbol | original
    rate: int = 1             # bits/symbol for persymbol
    tree: str = "random"      # random | star | chain | skeleton
    rho_min: float = 0.4      # edge correlation range (alpha)
    rho_max: float = 0.9      # (beta)
    seed: int = 0


FIG3 = GGMConfig("fig3", d=20, n=1000, tree="random")
# production size: 4096 machines, 2^20 samples each
PRODUCTION = GGMConfig("ggm-production", d=4096, n=1 << 20, method="sign")
