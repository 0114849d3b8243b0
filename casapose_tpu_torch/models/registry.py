"""Model registry: reference model names -> PyTorch modules.

Counterpart of ``casapose_tpu/models/registry.py`` (the variant table,
``parse_decoder_params``, ``get_model`` and ``Classifiers``, with the JAX
package's error messages) and of ``casapose_tpu/train.py::build_model_from_opt``,
which sizes the output for a harness config. Every name builds on every
backbone of ``models/resnet.py::RESNET_PARAMS``, in float32 or bfloat16.
"""

import torch

from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.models.casapose import CASAPoseModel, DecoderParams, PVNetModel, VariantSpec, init_weights

_DP = DecoderParams


def _spec(pc=(0, 0, 0, 0, 0), gu=False, bu=False, rc=(0, 0, 0, 0, 0), **kw):
    """Build a VariantSpec; gu/bu apply to the upsampled layers (1..3)."""
    params = tuple(
        _DP(weighted_clade=True, partial_conv=bool(pc[i]), guided_upsampling=gu and 0 < i < 4,
            bilinear_upsampling=bu and 0 < i < 4, reuse_conv=bool(rc[i]))
        for i in range(5)
    )
    return VariantSpec(decoder_params=params, **kw)


def parse_decoder_params(spec):
    """Per-layer DecoderParams from a compact description.

    Accepts a list of 5 DecoderParams / 5-tuples / dicts, or a string of 5
    comma-separated 5-bit groups "wc pc gu bu rc", e.g. the gcu5 wiring is
    ``"11000,11100,11100,11100,11000"``.
    """
    if isinstance(spec, str):
        groups = [g.strip() for g in spec.split(",")]
        if len(groups) != 5 or any(len(g) != 5 or set(g) - {"0", "1"} for g in groups):
            raise ValueError(
                f"decoder_params string must be 5 comma-separated 5-bit groups (wc pc gu bu rc), got {spec!r}"
            )
        spec = [tuple(c == "1" for c in g) for g in groups]
    if len(spec) != 5:
        raise ValueError(f"decoder_params needs exactly 5 per-layer entries, got {len(spec)}")
    out = []
    for entry in spec:
        if isinstance(entry, DecoderParams):
            out.append(entry)
        elif isinstance(entry, dict):
            out.append(DecoderParams(**entry))
        else:
            wc, pc, gu, bu, rc = entry
            out.append(DecoderParams(weighted_clade=bool(wc), partial_conv=bool(pc), guided_upsampling=bool(gu),
                                     bilinear_upsampling=bool(bu), reuse_conv=bool(rc)))
    return tuple(out)


MODEL_SPECS = {
    # Paper models (BMVC 2022)
    "casapose_c": _spec(stop_gradient_mask=False, halfsize_trainable=True),  # Conditional1
    "casapose_c_gu": _spec(gu=True),  # Conditional2
    "casapose_c_gcu3": _spec(pc=(1, 1, 1, 0, 0), gu=True),  # Conditional3
    "casapose_c_gcu4": _spec(pc=(1, 1, 1, 1, 0), gu=True),  # Conditional4
    "casapose_c_gcu5": _spec(pc=(1, 1, 1, 1, 1), gu=True),  # Conditional5 (flagship)
    # Configurable builder with the shipped "clade" params == gcu5 wiring.
    "casapose_custom": _spec(pc=(1, 1, 1, 1, 1), gu=True),
    # Alternative models
    "casapose_c_gcu5_sw5": _spec(rc=(1, 1, 1, 1, 1), gu=True),  # Conditional6
    "casapose_c_gcu4_sw1": _spec(pc=(0, 1, 1, 1, 1), rc=(1, 0, 0, 0, 0), gu=True),  # Conditional7
    "casapose_c_gcu5_sw1": _spec(  # Conditional8: no decoder-2 skip concats
        pc=(0, 1, 1, 1, 1), rc=(1, 0, 0, 0, 0), gu=True, decoder2_skip_connections=False
    ),
    "casapose_c_gcu4_bilat": _spec(pc=(1, 1, 1, 1, 0), gu=True, bu=True),  # Conditional9
    "casapose_c_gcu4_sw2": _spec(  # Conditional10: shared 1-2 (layer 1 re-applied WITH mask), partial 3-4
        pc=(0, 0, 1, 1, 0), rc=(1, 1, 0, 0, 0), gu=True, reuse_first_with_mask=True
    ),
}

PVNET_NAMES = ("pvnet", "pvnet_combined")

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16, torch.float32: None, torch.bfloat16: torch.bfloat16}


def compute_dtype(dtype):
    """None / "float32" / torch.float32 -> None (float32 throughout); "bfloat16" / torch.bfloat16 -> torch.bfloat16."""
    if dtype not in _DTYPES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype!r}")
    return _DTYPES[dtype]


def get_model(name, ver_dim, seg_dim, base_model="resnet18", output_labelmap=False, dtype=None, decoder_params=None,
              device="cuda", generator=None):
    """Build a model by reference name, in eval mode on ``device``, weights drawn from ``generator``.

    ``casapose_custom`` also takes ``decoder_params`` (see
    :func:`parse_decoder_params`); the shared convs are then reused without
    the class mask in decoder 2, the reference's generic builder. ``dtype``
    is the compute dtype (float32 or bfloat16; parameters stay float32).
    The weights are drawn on the CPU, so one seed gives the same model on
    any device; ``generator`` defaults to ``torch.Generator().manual_seed(0)``.
    """
    dev = resolve_device(device)
    dtype = compute_dtype(dtype)
    kwargs = dict(ver_dim=ver_dim, seg_dim=seg_dim, base_model=base_model, output_labelmap=output_labelmap,
                  dtype=dtype)
    if name in PVNET_NAMES:
        model = PVNetModel(**kwargs)
    else:
        if name not in MODEL_SPECS:
            raise ValueError(f"No such model `{name}`, available models: {sorted(MODEL_SPECS) + list(PVNET_NAMES)}")
        spec = MODEL_SPECS[name]
        if decoder_params is not None:
            if name != "casapose_custom":
                raise ValueError("decoder_params is only configurable for `casapose_custom`")
            spec = VariantSpec(decoder_params=parse_decoder_params(decoder_params), shared_reuse_with_mask=False)
        model = CASAPoseModel(spec, **kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(model, generator).eval().to(dev)


class _ClassifiersFactory:
    """API-compatible stand-in for the reference's ``Classifiers``."""

    def models_names(self):
        return sorted(MODEL_SPECS) + list(PVNET_NAMES)

    def get(self, name):
        if name not in self.models_names():
            raise ValueError(f"No such model `{name}`, available models: {self.models_names()}")

        def factory(ver_dim, seg_dim, base_model="resnet18", **kwargs):
            for key in ("input_shape", "input_segmentation_shape", "input_tensor", "weights", "backbone"):
                kwargs.pop(key, None)
            return get_model(name, ver_dim, seg_dim, base_model=base_model, **kwargs)

        return factory


Classifiers = _ClassifiersFactory()


def build_model_from_opt(opt, no_objects, device="cuda", generator=None):
    """The model a harness config asks for (``casapose_tpu/train.py::build_model_from_opt``).

    2k direction channels (times the objects for ``pvnet``), plus k
    confidences with ``estimate_confidence``. ``custom_decoder_params`` is
    passed on whatever the model, so that the registry refuses it for any
    model but ``casapose_custom``; ``compute_dtype`` bfloat16 selects the
    mixed-precision policy.
    """
    ver_dim = opt.no_points * 2 * (no_objects if opt.modelname == "pvnet" else 1)
    if opt.estimate_confidence:
        ver_dim += opt.no_points
    return get_model(opt.modelname, ver_dim=ver_dim, seg_dim=1 + no_objects, base_model=opt.backbonename,
                     dtype=getattr(opt, "compute_dtype", "float32"),
                     decoder_params=getattr(opt, "custom_decoder_params", None) or None, device=device,
                     generator=generator)
