"""Traffic kind ``tree``: the center learns a tree from each batch.

Set-up draws the traffic's batches of the configuration's tree GGM (the
same tree, a batch seed each) and learns one tree from each, which warms
every shape. The window calls ``learn_structure(x_k, strategy=...)`` back
to back, alternating k. A staged call runs the same chain stage by stage
(encode -> Gram -> weights and MWST) for the spans and for the check of
its intermediates; the check holds the timed entry's own weights
(``strategy_weights``, the call ``learn_structure`` makes) to the
reference as well.
"""
from __future__ import annotations

import numpy as np

from .. import gen, reference, roofline
from ..reference import BF16, REFERENCE, TF32


class Program:
    """The system under test: ``repro_torch``'s main path."""

    def __init__(self, strategy: dict, device):
        from repro_torch.core import chow_liu, estimators
        from repro_torch.core.strategy import Strategy

        self.cl, self.est = chow_liu, estimators
        self.s = Strategy(**strategy)

    def learn(self, x):
        return self.cl.learn_structure(x, strategy=self.s)

    def encode(self, x):
        return self.est.strategy_payload(x, self.s)

    def gram(self, p):
        return self.est.payload_gram(p, self.s)

    def mwst(self, g, n):
        w = self.est.weights_from_gram(g, n, self.s)
        return w, self.cl.adjacency_to_edges(self.cl.boruvka_mst(w))

    def entry_weights(self, x):
        """The weights as the timed entry makes them: ``learn_structure``
        calls ``strategy_weights`` and hands its result to the MWST."""
        return self.est.strategy_weights(x, self.s)


class Control:
    """The reference in the program's place, one precision below what
    the configuration states: the sign method's weights in bfloat16, the
    per-symbol Gram in TF32."""

    def __init__(self, strategy: dict, device):
        self.method = strategy.get("method", "sign")
        self.rate = strategy.get("rate", 1)
        self.gram_prec = TF32 if self.method == "persymbol" else REFERENCE
        self.w_prec = BF16 if self.method == "sign" else REFERENCE

    def learn(self, x):
        return self.mwst(self.gram(self.encode(x)), x.shape[0])[1]

    def encode(self, x):
        return reference.payload(x, self.method, self.rate)

    def gram(self, p):
        return reference.gram(p, self.method, self.rate, self.gram_prec)

    def mwst(self, g, n):
        w = reference.weights(g, n, self.method, self.w_prec)
        _, adj = reference.max_spanning_tree(w[None])
        iu, ju = np.nonzero(np.triu(adj[0].cpu().numpy(), k=1))
        return w, [(int(a), int(b)) for a, b in zip(iu, ju)]

    def entry_weights(self, x):
        return self.mwst(self.gram(self.encode(x)), x.shape[0])[0]


SYSTEMS = {"program": Program, "control": Control}


class Workload:
    unit = "tree"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 system: str = "program"):
        self.cfg, self.seed, self.device = config, int(seed), device
        self.d, self.n = int(config["d"]), int(config["n"])
        st = traffic["strategy"]
        self.method, self.rate = st.get("method", "sign"), st.get("rate", 1)
        self.batches = int(traffic.get("batches", 2))
        self.sys = SYSTEMS[system](st, device)
        self.xs = []
        self.first = []

    def setup(self) -> None:
        c = self.cfg
        self.xs = [gen.tree_batch(self.d, self.n, self.seed, b,
                                  c["rho_min"], c["rho_max"], self.device)
                   for b in range(self.batches)]
        self.first = [self.sys.learn(x) for x in self.xs]
        # a second pass: the first call on each batch after the other
        # batch's still warms up (~0.1 s once)
        for x in self.xs:
            self.sys.learn(x)

    def call(self, i: int):
        b = i % self.batches
        return b, self.sys.learn(self.xs[b])

    def units(self, answer) -> int:
        return 1

    def staged(self, spans) -> dict:
        b = self.seed % self.batches
        x = self.xs[b]
        with spans("encode"):
            p = self.sys.encode(x)
        with spans("gram"):
            g = self.sys.gram(p)
        with spans("mwst"):
            w, edges = self.sys.mwst(g, self.n)
        return {"batch": b, "payload": p, "gram": g, "weights": w,
                "edges": edges, "entry_weights": self.sys.entry_weights(x)}

    def counts(self) -> dict:
        """(operations, bytes) of each stage and of the whole tree."""
        n, d = self.n, self.d
        g = (roofline.gram_ops(n, d), roofline.gram_bytes(n, d, 1))
        return {"encode": (0, roofline.encode_bytes(n, d, 1)), "gram": g,
                "whole": (g[0], roofline.encode_bytes(n, d, 1) + g[1])}

    def check(self, answers, staged: dict | None) -> tuple[dict, list]:
        """(the numbers compared, and for each answer its own numbers):
        ``payload_mismatch`` (symbols unequal to the reference's) and
        ``gram_gap`` (max |G - G_ref| / n) of the staged call,
        ``weights_gap`` (max |w - w_ref| / max |w_ref|, the larger of the
        staged call's weights and the timed entry's own,
        ``strategy_weights``); ``tree_gap`` (the
        spanning tree's weight below the largest under the reference's
        weights, relative; 1 for no spanning tree) and ``answers_differ``
        (trees unlike the set-up's tree of the same batch) over every
        answer and the staged call."""
        import torch

        dev, n, d = self.device, self.n, self.d
        first = [_canon(e) for e in self.first]
        got = [(b, _canon(e)) for b, e in answers]
        sb = staged["batch"] if staged is not None else -1
        if staged is not None:
            got_staged = _canon(staged["edges"])
        numbers = {"payload_mismatch": 0.0, "gram_gap": 0.0,
                   "weights_gap": 0.0}
        gap = {}
        step = max(1, reference.BLOCK // d)
        for b, x in enumerate(self.xs):
            G = torch.zeros((d, d), dtype=torch.float64, device=dev)
            mismatch = 0
            for r0 in range(0, n, step):
                p = reference.payload(x[r0:r0 + step], self.method,
                                      self.rate)
                if b == sb:
                    mismatch += int((staged["payload"][r0:r0 + step]
                                     != p).sum())
                G += reference.gram(p, self.method, self.rate)
                del p
            w = reference.weights(G, n, self.method)
            if b == sb:
                numbers["payload_mismatch"] = float(mismatch)
                numbers["gram_gap"] = float(
                    (staged["gram"].double() - G).abs().max()) / n
                numbers["weights_gap"] = max(
                    reference.weights_gap(staged["weights"], w),
                    reference.weights_gap(staged["entry_weights"], w))
                # not compared: how far the stages stand from the entry
                numbers["entry_vs_staged"] = float(
                    (staged["entry_weights"].double()
                     - staged["weights"].double()).abs().max())
            trees = {t for bb, t in got if bb == b} | {first[b]}
            if b == sb:
                trees.add(got_staged)
            for t in trees:
                adj = reference.edges_adjacency(list(t), d, dev)
                gap[(b, t)] = float(reference.tree_gaps(adj[None],
                                                        w[None])[0])
            del G, w
        per = [{"tree_gap": gap[(b, t)],
                "answers_differ": float(t != first[b])} for b, t in got]
        staged_differs = staged is not None and got_staged != first[sb]
        numbers["tree_gap"] = max(gap.values())
        numbers["answers_differ"] = float(
            sum(a["answers_differ"] for a in per) + staged_differs)
        return numbers, per


def _canon(edges) -> tuple:
    """An edge list as a sorted tuple of (low, high) pairs."""
    return tuple(sorted((min(j, k), max(j, k)) for j, k in edges))
