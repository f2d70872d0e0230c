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
FIG7_STAR = GGMConfig("fig7-star", d=20, n=2000, tree="star",
                      rho_min=0.5, rho_max=0.5)
SKELETON = GGMConfig("skeleton", d=20, n=243586, tree="skeleton",
                     rho_min=0.6, rho_max=0.95)
# production size: 4096 machines, 2^20 samples each
PRODUCTION = GGMConfig("ggm-production", d=4096, n=1 << 20, method="sign")
