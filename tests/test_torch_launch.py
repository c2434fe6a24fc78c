"""The port's ``launch/`` mesh, sharding, roofline and dry-run tools
against the JAX reference, on the CPU.

* ``param_pspec``, ``opt_pspec``, ``batch_pspec``, ``cache_pspec`` and
  ``rules_overrides`` equal the reference's, leaf by leaf, for all ten
  architectures and every ``SHAPES_BY_NAME`` entry on a fake 2 x 16 x 16
  mesh (and the training cells' ``seq_sp`` override): the port's trees
  from models built on ``meta``, the reference's from ``jax.eval_shape``.
* ``analytic_flops`` and ``analytic_bytes`` equal the reference's exactly
  for every (arch, shape) and chip count; ``roofline_terms`` equals the
  reference's once its TPU constants are replaced by the card's.
* ``dryrun_cell``'s per-device bytes equal a count made leaf by leaf from
  the reference's shapes and specs, and its batch a count by hand;
  ``hydro_dryrun``'s state and halo bytes a count by hand; the CLIs write
  only under ``--out``; the production and test meshes.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES_BY_NAME as JSHAPES  # noqa: E402
from repro.data.pipeline import make_batch_specs as jmake_batch_specs  # noqa: E402,E501
from repro.distributed.api import logical_rules as jlogical_rules  # noqa: E402,E501
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import model as jmodel  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_config  # noqa: E402
from repro_torch.configs.base import shape_applicable  # noqa: E402
from repro_torch.distributed.api import PartitionSpec  # noqa: E402
from repro_torch.launch import dryrun, hydro_dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh  # noqa: E402,E501
from repro_torch.launch.sharding import (  # noqa: E402
    _walk, make_all_specs, rules_overrides,
)

AXES = dict(pod=2, data=16, model=16)


def _fake_mesh(**axes):
    return SimpleNamespace(shape=dict(axes))


def jleaves(tree):
    """{path of dict keys: leaf} of a reference tree, PartitionSpecs as
    leaves."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(str(p.key) for p in path if hasattr(p, "key")): leaf
            for path, leaf in flat}


def tleaves(tree):
    out = {}
    for keys, leaf in _walk(tree):
        assert keys not in out
        out[keys] = leaf
    return out


def assert_specs_equal(got, want, what):
    g, w = tleaves(got), jleaves(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert isinstance(g[k], PartitionSpec), (what, k)
        assert tuple(w[k]) == g[k], (what, k, g[k], w[k])


def assert_shapes_equal(got, want, what):
    g, w = tleaves(got), jleaves(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert tuple(g[k].shape) == tuple(w[k].shape), (what, k)


_JPARAMS = {}


def jparams(arch):
    if arch not in _JPARAMS:
        cfg = jget_config(arch)
        _JPARAMS[arch] = jax.eval_shape(
            lambda k: jmodel.init_params(cfg, k),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return _JPARAMS[arch]


def jcache(jcfg, params_sh, b, seq_len):
    def build(params):
        batch = {"tokens": jnp.zeros((b, 1), jnp.int32)}
        if jcfg.family == "vlm":
            batch["vision"] = jnp.zeros((b, jcfg.vision_tokens,
                                         jcfg.d_model), jnp.bfloat16)
        if jcfg.family == "audio":
            batch["frames"] = jnp.zeros(
                (b, 8 * jcfg.encoder_seq_ratio, jcfg.d_model), jnp.bfloat16)
        return jmodel.init_cache(jcfg, params, batch, b, seq_len)
    return jax.eval_shape(build, params_sh)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_match_the_reference_for_every_shape(arch):
    """The reference's ``make_all_specs`` built from its parts (one
    ``eval_shape`` of the parameters per architecture)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == AXES
    params_sh = jparams(arch)
    for name, shape in SHAPES_BY_NAME.items():
        jshape = JSHAPES[name]
        assert rules_overrides(shape, cfg) == jsharding.rules_overrides(
            jshape, jcfg)
        assert rules_overrides(shape) == jsharding.rules_overrides(jshape)
        over = {"seq_sp": None} if shape.kind == "train" else {}
        ov = dict(over, **jsharding.rules_overrides(jshape, jcfg))
        got = make_all_specs(cfg, shape, mesh, overrides=over)
        cspec = cache_sh = None
        if shape.kind == "decode":
            # traced outside the rules: the encoder's ``constrain`` needs a
            # real mesh, and the shapes do not depend on the rules
            cache_sh = jcache(jcfg, params_sh, jshape.global_batch,
                              jshape.seq_len)
            probe = jcache(jcfg, params_sh, jshape.global_batch + 1,
                           jshape.seq_len)
        with jlogical_rules(_fake_mesh(**AXES), ov):
            pspec = jsharding.param_pspec(params_sh)
            ospec = jsharding.opt_pspec(pspec)
            bspec = jsharding.batch_pspec(jmake_batch_specs(jcfg, jshape))
            if shape.kind == "decode":
                cspec = jsharding.cache_pspec(cache_sh, probe)
        g_params, g_batch, g_cache, g_p, g_o, g_b, g_c = got
        assert_shapes_equal(g_params, params_sh, (arch, "params"))
        assert_specs_equal(g_p, pspec, (arch, name, "params"))
        assert_specs_equal(g_o, ospec, (arch, name, "opt"))
        assert_specs_equal(g_b, bspec, (arch, name, "batch"))
        if shape.kind == "decode":
            assert_shapes_equal(g_cache, cache_sh, (arch, name, "cache"))
            assert_specs_equal(g_c, cspec, (arch, name, "cache"))
        else:
            assert g_cache is None and g_c is None


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_flops_and_bytes_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name, shape in SHAPES_BY_NAME.items():
        jshape = JSHAPES[name]
        assert roofline.analytic_flops(cfg, shape) == \
            jroofline.analytic_flops(jcfg, jshape)
        for chips in (1, 8, 256, 512):
            assert roofline.analytic_bytes(cfg, shape, chips) == \
                jroofline.analytic_bytes(jcfg, jshape, chips)


@pytest.mark.parametrize("arch", ["granite-8b", "dbrx-132b", "xlstm-125m",
                                  "zamba2-2.7b", "seamless-m4t-large-v2"])
def test_roofline_terms_equal_with_the_cards_constants(arch, monkeypatch):
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    for k in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroofline, k, getattr(roofline, k))
    jcfg, cfg = jget_config(arch), get_config(arch)
    coll = {"all-reduce": 3e9, "all-gather": 1e9, "reduce-scatter": 0.0,
            "all-to-all": 5e8, "collective-permute": 0.0}
    coll["total"] = sum(coll.values())
    for name, shape in SHAPES_BY_NAME.items():
        for chips in (256, 512):
            assert roofline.roofline_terms(cfg, shape, chips, coll) == \
                jroofline.roofline_terms(jcfg, JSHAPES[name], chips, coll)


def _count(tree, spec_tree, axes):
    """Per-device bytes from the reference's shapes and specs: each
    leaf's bytes over the sizes of the axes its spec names."""
    leaves, specs = jleaves(tree), jleaves(spec_tree)
    total = 0
    for k, leaf in leaves.items():
        n = 1
        for part in specs[k]:
            for a in ((part,) if isinstance(part, str) else (part or ())):
                n *= axes[a]
        total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // n
    return total


@pytest.mark.parametrize("arch, shape_name, multi_pod", [
    ("granite-8b", "train_4k", False), ("qwen2-moe-a2.7b", "train_4k", True),
    ("h2o-danube-1.8b", "decode_32k", True),
    ("zamba2-2.7b", "long_500k", False)])
def test_dryrun_cell_bytes_match_a_count(arch, shape_name, multi_pod):
    res = dryrun.dryrun_cell(arch, shape_name, multi_pod, verbose=False)
    jcfg, jshape = jget_config(arch), JSHAPES[shape_name]
    axes = AXES if multi_pod else dict(data=16, model=16)
    assert res["chips"] == int(np.prod(list(axes.values())))
    over = {"seq_sp": None} if jshape.kind == "train" and \
        jcfg.family != "moe" else {}
    ov = dict(over, **jsharding.rules_overrides(jshape, jcfg))
    params_sh = jparams(arch)
    if jshape.kind == "decode":
        cache = jcache(jcfg, params_sh, jshape.global_batch, jshape.seq_len)
        probe = jcache(jcfg, params_sh, jshape.global_batch + 1,
                       jshape.seq_len)
    with jlogical_rules(_fake_mesh(**axes), ov):
        pspec = jsharding.param_pspec(params_sh)
        batch = jmake_batch_specs(jcfg, jshape)
        bspec = jsharding.batch_pspec(batch)
        if jshape.kind == "decode":
            cspec = jsharding.cache_pspec(cache, probe)
    mem = res["memory"]
    assert mem["params_bytes_per_device"] == _count(params_sh, pspec, axes)
    assert mem["batch_bytes_per_device"] == _count(batch, bspec, axes)
    want = mem["params_bytes_per_device"] + mem["batch_bytes_per_device"]
    if jshape.kind == "train":
        f32 = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), params_sh)
        opt = 2 * _count(f32, pspec, axes) + 4
        assert mem["opt_bytes_per_device"] == opt
        want += opt
        # tokens and labels, int32 (B, S), over the batch axes by hand
        dp = axes.get("pod", 1) * axes["data"]
        assert mem["batch_bytes_per_device"] == \
            2 * jshape.global_batch * jshape.seq_len * 4 // dp
    else:
        assert mem["cache_bytes_per_device"] == _count(cache, cspec, axes)
        want += mem["cache_bytes_per_device"]
    assert mem["argument_size_in_bytes"] == want
    assert mem["fits"] == (want <= 80e9)
    assert mem["temp_size_in_bytes"] is None
    assert res["roofline"]["collectives"] is None and res["note"]
    assert res["roofline"]["compute_s"] == jroofline.analytic_flops(
        jcfg, jshape)["total"] / res["chips"] / 989e12


def test_dryrun_skips_and_cli_writes_only_under_out(tmp_path, capsys):
    res = dryrun.dryrun_cell("granite-8b", "long_500k", False, verbose=False)
    assert "skipped" in res
    ok, _ = shape_applicable(get_config("granite-8b"),
                             SHAPES_BY_NAME["long_500k"])
    assert not ok
    out = tmp_path / "cells"
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--mesh", "both", "--out", str(out)]) == 0
    files = sorted(p.name for p in out.iterdir())
    assert files == ["dryrun_multipod_xlstm-125m_decode_32k.json",
                     "dryrun_pod_xlstm-125m_decode_32k.json"]
    cell = json.loads((out / files[0]).read_text())
    assert cell["chips"] == 512 and cell["memory"]["fits"]
    assert "all requested cells sized" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cells"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_hydro_dryrun_counts(multi_pod, tmp_path):
    res = hydro_dryrun.hydro_dryrun(4, multi_pod)
    n = 128                                 # 16 sub-grids of 8 per edge
    chips = 512 if multi_pod else 256
    assert res["chips"] == chips and res["grid"] == [5, n, n, n]
    assert res["subgrids"] == 4096 and res["cells"] == n ** 3
    sx = 32 if multi_pod else 16
    assert res["block"] == [5, n // sx, n // 16, n]
    assert res["state_bytes_per_device"] == 5 * n ** 3 * 4 // chips
    assert res["halo_bytes_per_device_per_step"] == \
        3 * 5 * 4 * 2 * 3 * n * (n // 16 + n // sx)
    assert res["temp_bytes_per_device"] is None
    assert res["collectives"] is None
    assert hydro_dryrun.main(["--levels", "2", "--out", str(tmp_path)]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["hydro_dryrun_pod.json"]


def test_meshes():
    pod = make_production_mesh()
    assert pod.axis_names == ("data", "model") and pod.size == 256
    assert pod.shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    m = make_test_mesh(2, 2, devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2}
    with pytest.raises(AssertionError):
        make_test_mesh(2, 1, devices=["cpu"])
