"""The port's model accounting (``repro_torch.launch.roofline``) and the
config's shape set against the reference, by spec counting (nothing is
allocated): ``active_params`` for every registered config at full size,
``model_flops`` and ``cell_skip_reason`` for every (config, shape) in
``SHAPES``, and the ``main_repeats`` depth cut of ``stages`` /
``param_specs`` / ``cache_specs``.  All equal exactly."""
import jax
import pytest

import repro.configs as JC
from repro.launch import roofline as JR
from repro.models import model as JM
from repro.models.params import is_spec as j_is_spec
import repro_torch.configs as TC
from repro_torch.launch import roofline as TR
from repro_torch.models import model as TM
from repro_torch.models.params import is_spec


def _shapes_j(tree):
    return [tuple(s.shape) for s in jax.tree_util.tree_leaves(tree, is_leaf=j_is_spec)]


def _shapes_t(tree):
    out = []

    def walk(t, path):
        if is_spec(t):
            out.append((tuple(path), tuple(t.shape)))
        elif isinstance(t, dict):
            for k in sorted(t):  # jax flattens a dict in sorted key order
                walk(t[k], path + [k])
        else:
            for i, v in enumerate(t):
                walk(v, path + [i])
    walk(tree, [])
    return [s for _, s in out]


def _stages(cfg, k):
    return [(tuple((ls.mixer, ls.ffn) for ls in s.group), s.repeats) for s in cfg.stages(k)]


def test_registry_and_shapes():
    assert set(TC.REGISTRY) == set(JC.REGISTRY)
    assert set(TC.ASSIGNED) == set(JC.ASSIGNED) and "cgra-edge" not in TC.ASSIGNED
    assert {k: tuple(vars(v).values()) for k, v in TC.SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in JC.SHAPES.items()}


@pytest.mark.parametrize("name", sorted(JC.REGISTRY))
def test_active_params_and_model_flops(name):
    jcfg, tcfg = JC.get_config(name), TC.get_config(name)
    assert TR.active_params(tcfg) == JR.active_params(jcfg)
    for sk in JC.SHAPES:
        assert TR.model_flops(tcfg, TC.SHAPES[sk]) == JR.model_flops(jcfg, JC.SHAPES[sk])
        assert TC.cell_skip_reason(tcfg, TC.SHAPES[sk]) == JC.cell_skip_reason(
            jcfg, JC.SHAPES[sk])


@pytest.mark.parametrize("name", ["olmo-1b", "gemma3-4b", "jamba-v0.1-52b",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("k", [1, 2])
def test_main_repeats_cuts_the_same_depth(name, k):
    jcfg, tcfg = JC.get_config(name), TC.get_config(name)
    assert _stages(tcfg, k) == _stages(jcfg, k)
    assert _stages(tcfg, None) == _stages(jcfg, None)
    assert _shapes_t(TM.param_specs(tcfg, k)) == _shapes_j(JM.param_specs(jcfg, k))
    assert _shapes_t(TM.cache_specs(tcfg, 2, 64, k)) == _shapes_j(JM.cache_specs(jcfg, 2, 64, k))


def test_roofline_terms_and_extrapolation():
    t = TR.RooflineTerms(flops=989e12, bytes=3.35e12 * 2, attn_core_bytes=3.35e12 * 1.5)
    assert t.t_compute == pytest.approx(1.0) and t.t_memory == pytest.approx(2.0)
    assert t.bottleneck == "memory" and t.t_bound_overlap == pytest.approx(2.0)
    assert t.t_bound_serial == pytest.approx(3.0)
    assert t.t_bound_overlap_flash == pytest.approx(1.0)
    assert set(t.as_dict()) >= {"flops", "bytes", "t_compute_s", "t_memory_s", "bottleneck"}
    assert TR.extrapolate(3.0, 5.0, 16) == JR.extrapolate(3.0, 5.0, 16) == 33.0
    # the port's peaks are the card's, not the reference's
    assert (TR.PEAK_FLOPS, TR.HBM_BW) == (989e12, 3.35e12)
