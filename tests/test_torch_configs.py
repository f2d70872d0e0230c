"""The paper's GGM configurations and the skeleton's joints: the port's
copies (``repro_torch.configs.ggm_paper``, ``repro_torch.core.trees``)
held to ``repro``'s field for field."""
import dataclasses


def test_every_ggm_config_is_repros():
    from repro.configs import ggm_paper as j
    from repro_torch.configs import ggm_paper as t

    def configs(mod):
        return {name: v for name, v in vars(mod).items()
                if isinstance(v, mod.GGMConfig)}

    want, got = configs(j), configs(t)
    assert set(got) == set(want) >= {"FIG3", "FIG7_STAR", "SKELETON",
                                     "PRODUCTION"}
    for name in want:
        assert dataclasses.asdict(got[name]) == \
            dataclasses.asdict(want[name]), name
    assert [f.name for f in dataclasses.fields(t.GGMConfig)] == \
        [f.name for f in dataclasses.fields(j.GGMConfig)]


def test_skeleton_joints_and_edges_are_repros():
    from repro.core import trees as j
    from repro_torch.core import trees as t

    assert t.SKELETON_JOINTS == j.SKELETON_JOINTS
    assert t.SKELETON_EDGES == j.SKELETON_EDGES
    assert len(t.SKELETON_JOINTS) == len(t.SKELETON_EDGES) + 1
