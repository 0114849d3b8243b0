"""Keras ``.h5`` weights in the port against the JAX package, on the CPU (h5py is on this host only).

Each ``.h5`` is written here by the JAX package's own ``export_keras_h5``
from JAX variables (init plus one train-mode pass, tests/torch_parity.py),
for four layouts: a model without partial convolutions
(``casapose_c_gu``), the non-shared partial convolutions of the flagship
(``casapose_c_gcu5``, ``pv_block_N_prepare_conv2d`` groups of (ch, 3, 3,
dim) kernels), the trainable HalfSize of ``casapose_c`` (an inner
``conv2d`` group), and the learned-blend CLADE layer (``alpha_1`` /
``alpha_2``; no registry model builds it, so a one-layer module).

* ``import_keras_h5`` in both packages loads the same arrays, bit for bit,
  into a port model that started from other weights, and both forwards
  then agree at tests/test_torch_model.py's rtol 1e-4, atol 1e-4 (the
  CLADE layer at tests/test_torch_layers.py's atol);
* the port's ``export_keras_h5`` writes the JAX file again: the same
  groups in the same order, the same ``weight_names`` order per group, the
  same arrays, bit for bit;
* a qubvel-style ImageNet ``.h5`` named by ``$CASAPOSE_IMAGENET_H5`` loads
  the same backbone arrays in both packages; without a file the port says
  so and loads nothing (the JAX package would try a download: not run).
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import calibrated_variables, single_torch_thread  # noqa: F401 (autouse)

OC, K, H, W, B = 2, 3, 64, 64, 2
SEG_DIM = 1 + OC
MODELS = ("casapose_c_gu", "casapose_c_gcu5", "casapose_c")


def _layout(path):
    """[(group, [(weight name, array), ...]), ...] in the file's order (``layer_names``, ``weight_names``)."""
    import h5py

    with h5py.File(path, "r") as f:
        out = []
        for g in f.attrs["layer_names"]:
            g = g.decode() if isinstance(g, bytes) else g
            names = [n.decode() if isinstance(n, bytes) else n for n in f[g].attrs["weight_names"]]
            out.append((g, [(n, np.asarray(f[g][n])) for n in names]))
        return out


def _assert_same_file(got_path, want_path):
    got, want = _layout(got_path), _layout(want_path)
    assert [g for g, _ in got] == [g for g, _ in want]
    for (g, gw), (_, ww) in zip(got, want):
        assert [n for n, _ in gw] == [n for n, _ in ww], g
        for (n, a), (_, b) in zip(gw, ww):
            assert a.dtype == b.dtype and a.shape == b.shape, n
            np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.fixture(scope="module", params=MODELS)
def model_h5(request, tmp_path_factory):
    """(name, flax model, JAX variables, .h5 written by the JAX package, image)."""
    from casapose_tpu.core.checkpoint import export_keras_h5, unflatten_params
    from casapose_tpu.models.registry import get_model as jax_get_model

    name = request.param
    img = np.random.default_rng(0).normal(size=(B, H, W, 3)).astype(np.float32)
    jm = jax_get_model(name, ver_dim=3 * K, seg_dim=SEG_DIM)
    variables = unflatten_params(calibrated_variables(jm, img))
    path = str(tmp_path_factory.mktemp("h5") / f"{name}.h5")
    export_keras_h5(path, variables, model=jm)
    return name, jm, variables, path, img


def _port_model(name, seed=123):
    from casapose_tpu_torch.models.registry import get_model

    return get_model(name, 3 * K, SEG_DIM, device="cpu", generator=torch.Generator().manual_seed(seed))


def test_import_loads_what_jax_loads(model_h5):
    import jax

    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu.core.checkpoint import import_keras_h5 as jax_import
    from casapose_tpu_torch.core.checkpoint import import_keras_h5
    from casapose_tpu_torch.core.convert import to_jax_variables

    name, jm, variables, path, img = model_h5
    template = jax.jit(lambda x: jm.init(jax.random.PRNGKey(7), x, train=False))(img[:1])
    want_vars, want_n, want_skipped = jax_import(path, dict(template))
    model = _port_model(name)
    n, skipped = import_keras_h5(path, model)
    assert (n, sorted(skipped)) == (want_n, sorted(want_skipped)) and not skipped
    want = {f"{col}/{k}": v for col in ("params", "batch_stats") for k, v in flatten_params(want_vars[col]).items()}
    got = to_jax_variables(model.state_dict())
    assert got.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)

    out_j = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(want_vars, img))
    with torch.no_grad():
        out_p = model(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out_p, out_j, rtol=1e-4, atol=1e-4)


def test_export_writes_the_jax_file(model_h5, tmp_path):
    from casapose_tpu_torch.core.checkpoint import export_keras_h5, import_keras_h5

    name, _, _, path, _ = model_h5
    model = _port_model(name)
    import_keras_h5(path, model)
    out = export_keras_h5(str(tmp_path / "port.h5"), model)
    _assert_same_file(out, path)


def test_learned_blend_clade(tmp_path):
    from casapose_tpu.core.checkpoint import export_keras_h5 as jax_export
    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu.core.checkpoint import import_keras_h5 as jax_import
    from casapose_tpu.models.layers import ClassAdaptiveWeightedNormWithInput as JaxNorm
    from casapose_tpu_torch.core.checkpoint import export_keras_h5, import_keras_h5
    from casapose_tpu_torch.core.convert import to_jax_variables
    from casapose_tpu_torch.models.layers import ClassAdaptiveWeightedNormWithInput

    rng = np.random.default_rng(8)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    layer = "pv_block_6_clade"
    params = {"gamma": f32(3, 5), "beta": f32(3, 5), "alpha_1": np.array([0.3], np.float32),
              "alpha_2": np.array([0.8], np.float32)}
    stats = {"mean": f32(5), "var": np.abs(f32(5)) + 0.5}
    variables = {"params": {layer: params}, "batch_stats": {layer: {"bn": stats}}}
    path = jax_export(str(tmp_path / "clade.h5"), variables)

    def holder():
        h = torch.nn.Module()
        h.add_module(layer, ClassAdaptiveWeightedNormWithInput(3, 5, learned_blend=True))
        return h.eval()

    h = holder()
    n, skipped = import_keras_h5(path, h)
    template = {"params": {layer: {k: np.zeros_like(v) for k, v in params.items()}},
                "batch_stats": {layer: {"bn": {k: np.zeros_like(v) for k, v in stats.items()}}}}
    want_vars, want_n, _ = jax_import(path, template)
    assert n == want_n == 6 and not skipped
    got = to_jax_variables(h.state_dict())
    for col in ("params", "batch_stats"):
        for k, v in flatten_params(want_vars[col]).items():
            np.testing.assert_array_equal(got[f"{col}/{k}"], v, err_msg=k)
    _assert_same_file(export_keras_h5(str(tmp_path / "port.h5"), h), path)

    x, gamma_in, beta_in = f32(2, 6, 7, 5), f32(2, 3, 5), f32(2, 3, 5)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 6, 7))]
    ref = np.asarray(JaxNorm(num_classes=3, learned_blend=True).apply(
        {"params": want_vars["params"][layer], "batch_stats": want_vars["batch_stats"][layer]}, x, onehot, gamma_in,
        beta_in, use_running_average=True))
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    with torch.no_grad():
        out = getattr(h, layer)(nchw(x), nchw(onehot), torch.from_numpy(gamma_in), torch.from_numpy(beta_in))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, atol=1e-5, rtol=0)


def _write_imagenet_h5(path, variables):
    """A qubvel-style ImageNet file: one top-level group per backbone layer, Keras's doubled layer names."""
    import h5py

    from casapose_tpu.core.checkpoint import flatten_params

    keras = {"kernel": "kernel", "scale": "gamma", "bias": "beta", "mean": "moving_mean", "var": "moving_variance"}
    flat = {**flatten_params(variables["params"]["backbone"]), **flatten_params(variables["batch_stats"]["backbone"])}
    with h5py.File(path, "w") as f:
        layers = sorted({k.split("/")[0] for k in flat})
        f.attrs["layer_names"] = [n.encode() for n in layers]
        for layer in layers:
            g = f.create_group(layer)
            names = []
            for k, v in sorted(flat.items()):
                if k.split("/")[0] == layer:
                    names.append(f"{layer}/{keras[k.split('/')[1]]}:0".encode())
                    g.create_dataset(names[-1].decode(), data=v)
            g.attrs["weight_names"] = names


def test_imagenet_backbone_loads_as_in_jax(model_h5, tmp_path, monkeypatch):
    import jax

    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu.core.checkpoint import load_imagenet_backbone as jax_load
    from casapose_tpu_torch.core.checkpoint import load_imagenet_backbone
    from casapose_tpu_torch.core.convert import to_jax_variables

    name, jm, variables, _, img = model_h5
    path = str(tmp_path / "resnet18_imagenet_1000_no_top.h5")
    _write_imagenet_h5(path, variables)
    monkeypatch.setenv("CASAPOSE_IMAGENET_H5", path)
    template = jax.jit(lambda x: jm.init(jax.random.PRNGKey(7), x, train=False))(img[:1])
    want_vars, want_n = jax_load(dict(template), base_model="resnet18")
    model = _port_model(name)
    n = load_imagenet_backbone(model, base_model="resnet18")
    assert n == want_n > 60
    got = to_jax_variables(model.state_dict())
    for col in ("params", "batch_stats"):
        for k, v in flatten_params(want_vars[col]["backbone"]).items():
            np.testing.assert_array_equal(got[f"{col}/backbone/{k}"], v, err_msg=k)
            np.testing.assert_array_equal(v, flatten_params(variables[col]["backbone"])[k], err_msg=k)


def test_without_an_imagenet_file_nothing_loads(tmp_path, monkeypatch, capsys):
    from casapose_tpu_torch.core.checkpoint import find_imagenet_h5, load_imagenet_backbone

    monkeypatch.setenv("CASAPOSE_IMAGENET_H5", str(tmp_path / "missing.h5"))
    monkeypatch.setenv("HOME", str(tmp_path))
    model = _port_model("casapose_c_gcu5")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_imagenet_backbone(model, base_model="resnet18") == 0
    assert "imagenet weights unavailable for resnet18" in capsys.readouterr().out
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert find_imagenet_h5("resnet9") is None


def test_without_h5py_the_error_names_the_npz_route(tmp_path, monkeypatch):
    import sys

    from casapose_tpu_torch.core.checkpoint import export_keras_h5, h5py_available, import_keras_h5

    monkeypatch.setitem(sys.modules, "h5py", None)
    assert not h5py_available()
    model = _port_model("casapose_c_gu")
    for call in (lambda: import_keras_h5(str(tmp_path / "w.h5"), model),
                 lambda: export_keras_h5(str(tmp_path / "w.h5"), model)):
        with pytest.raises(ImportError, match="convert_h5_weights.py"):
            call()
