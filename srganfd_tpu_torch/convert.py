"""Carry generator weights between the JAX package's Flax tree and the
port's reference-named state dict.

The Flax tree of an RRDB generator (``RRDBNet``/``BSRGAN``) holds
``Conv_0`` (conv1), the trunk as ``RRDB_{i}/ResidualDenseBlock_{j}/
conv{k}_{kernel,bias}`` (or, with ``scan_blocks=True``, one
``ScanRRDB/RRDB_0`` subtree whose leaves carry a leading block axis),
``Conv_1`` (conv2), then the upsampling convs, conv3 and conv4 in call
order, each as ``Conv_n/Conv_0/{kernel,bias}`` with HWIO kernels. The
state dict uses the reference names ``conv1``, ``trunk.{i}.rdb{j}.conv{k}``,
``conv2``, ``upsampling{n}.0``, ``conv3.0``, ``conv4`` with OIHW weights,
as ``tools/export_to_torch.py`` writes them (the mapping is this module's
own copy).

A ``RealESRGANNet`` tree (``realesrgan_x4``/``x2``) holds the same
leaves as an x4 RRDB tree: ``Conv_0`` (conv1, whose input channels are
the unshuffled ones: 3 at x4, 12 at x2, 48 at x1), the trunk, ``Conv_1``
(conv2), ``Conv_2``/``Conv_3`` (the two upsampling convs), ``Conv_4``
(the HR conv, ``conv3.0``) and ``Conv_5`` (``conv4``), and takes the same
names (``tools/export_torch_weights.py`` exports the family through the
RRDB map). ``flax_to_state_dict`` sends a tree whose conv1 takes 12 or 48
channels to the Real-ESRGAN mapping, which refuses any other layout.

A ``BSRGANtrans`` tree has the same conv1 and trunk, then ``Conv_1`` (the
stride-2 downsample), ``TransformerEncoderLayer_{0,1}``, ``Conv_2`` (the
conv after the bottleneck's x2 upsample), ``Conv_3`` (conv2), ``Conv_4``
(upsampling1), ``Conv_5`` (conv3) and ``Conv_6`` (conv4). The reference's
own names for this arch are not available, so the port chooses them:

- ``Conv_1`` -> ``down_conv``; ``Conv_2`` -> ``up_conv``; ``Conv_3..6`` ->
  ``conv2``, ``upsampling1.0``, ``conv3.0``, ``conv4``;
- ``TransformerEncoderLayer_{i}`` -> ``transformer.{i}``, inside which
  ``MultiHeadDotProductAttention_0/{query,key,value}`` (kernels (C, H, D),
  biases (H, D)) -> ``self_attn.in_proj_weight`` (3C, C) and
  ``self_attn.in_proj_bias`` (3C,), q, k, v stacked in that order with the
  output features head-major (h * D + d); ``.../out`` (kernel (H, D, C))
  -> ``self_attn.out_proj``; ``Dense_{0,1}`` -> ``linear{1,2}``;
  ``LayerNorm_{0,1}`` (scale, bias) -> ``norm{1,2}`` (weight, bias).

The transformer names and layouts are those of torch's
``nn.TransformerEncoderLayer``.

A ``DiscriminatorUNet`` tree holds ``Conv_0`` (the first conv), the
spectral-norm convs ``SNConv_0..7`` (``kernel``, HWIO, no bias) and
``Conv_1`` (the last conv); its ``spectral`` collection holds
``SNConv_i/u``. They map onto the reference names ``conv0``,
``conv{i+1}.weight`` with the buffer ``conv{i+1}.u``, and ``conv9``. The
frozen networks of the losses map too, so that tests can load the JAX
package's surrogates: VGG19's ``conv{i}`` onto ``features.{i}`` and
AlexNet's ``conv{i}`` onto ``alex.{i}``.

A ``DiscriminatorUNetSA`` tree (``discriminator_unet_sa``) holds the same
leaves and ``TokenSelfAttention_{0,1,2}`` (the attentions after down2,
after down3 and on up1), each with ``query``/``key``/``value`` kernels (C,
H, D) and biases (H, D) and an ``out`` kernel (H, D, C) and bias; they map
onto ``attn_down2``, ``attn_down3`` and ``attn_up1`` in the layout of
torch's ``nn.MultiheadAttention``, as the transformer's attention maps.

An ``AttentionUNetDiscriminator`` tree (``uNetDiscriminatorAesrgan``) holds
``Conv_0``/``Conv_1`` (``conv0``/``conv9``), ``SNConv_0..8`` (``conv1``,
``conv2``, ``conv3``, ``gating``, ``conv4..conv8``: the module's call
order), ``_AddAttn_{i}`` (``attn_{i+1}``: ``Conv_0..3`` -> ``theta`` (no
bias), ``phi``, ``psi``, ``W.0``; ``BatchNorm_0`` scale and bias -> ``W.1``
weight and bias) and ``_UNetCat_{i}/SNConv_0`` (``cat_{i+1}.convU``). Its
``spectral`` collection gives each SN conv's ``u`` (``SNConv_i/u`` at the
top, ``_UNetCat_i/SNConv_0/u``), its ``batch_stats`` collection each
gate's ``running_mean``/``running_var`` (``_AddAttn_i/BatchNorm_0/mean``,
``var``): the inverse of ``tools/port_torch_weights.py``'s
``convert_attention_unet_discriminator``. The ensemble
(``discriminator_attention_unet_ms``) holds one such tree a scale, ``D0``,
``D1``, ..., whose names take the prefix ``D{s}.``.

A ``DiscriminatorVGG128`` tree (``discriminator``) holds ``Conv_0..9``
(``features.{0, 2, 5, ..., 26}``, the first with a bias, the others
without), ``BatchNorm_0..8`` (scale, bias -> ``features.{3, 6, ..., 27}``
weight, bias; its ``batch_stats`` collection's mean and var ->
``running_mean``, ``running_var``) and ``Dense_0``/``Dense_1``
(``classifier.0``/``classifier.2``, kernels transposed). The JAX module
transposes its 4 x 4 map to NCHW before it flattens, so ``Dense_0``'s rows
are already in the order of torch's ``flatten(1)``: the transpose is the
whole of that mapping, the inverse of ``tools/port_torch_weights.py``'s
``convert_vgg_discriminator``.

A ``GeneratorRRDB`` tree (``gen_rrdb2x``) holds ``Conv_0`` (its first
conv, 12 input channels at x2), the trunk ``RRDB_{i}``, ``Conv_1`` (the
trunk conv), ``Conv_2``/``Conv_3`` (the two upsampling convs), ``Conv_4``
(the LAST conv) and ``Conv_5`` (the HR conv): the JAX module writes
``conv(out)(lrelu(conv(feat)(z)))``, and Flax names the outer conv first.
Its module names are a ``RealESRGANNet`` x2 tree's, whose ``Conv_4`` is the
HR conv and ``Conv_5`` the last; the two differ only in which of
``Conv_4``/``Conv_5`` maps the features to the output channels, so
``flax_to_state_dict`` tells them apart by that conv's shape, never by
conv1's channels. The reference tree (``A-ESRGAN/model.py:180-215``) is not
at hand; its docstring calls the module BasicSR-style, so the port takes
BasicSR's names: ``Conv_0`` -> ``conv_first``, ``RRDB_{i}`` ->
``body.{i}.rdb{j}.conv{k}``, ``Conv_1`` -> ``conv_body``, ``Conv_2``/
``Conv_3`` -> ``conv_up1``/``conv_up2``, ``Conv_5`` -> ``conv_hr``,
``Conv_4`` -> ``conv_last``.

A ``GeneratorRPA`` tree (``gen_rpa2x``) holds ``Conv_0`` (the first conv),
``_RPABlock_{i}/Conv_{0..3}`` (the two 1x1 convs, the gate's 3x3 conv, the
block's last conv), ``_PAUpsample_{i}/Conv_{0..2}`` (the 1x1 conv, the 1x1
gate conv, the 3x3 conv) and ``Conv_1``/``Conv_2`` (the two tail convs).
The port chooses the names (the reference's are not at hand): ``conv1``,
``rpa.{i}.conv{1..4}``, ``us.{i}.conv1``, ``us.{i}.pa_conv``,
``us.{i}.conv2``, ``conv2``, ``conv3``.

Each mapping takes only the tree it knows: a leaf it would not map raises
instead of being dropped or mis-assigned.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

__all__ = [
    "flax_to_state_dict", "rrdb_flax_to_state_dict", "realesrgan_flax_to_state_dict",
    "bsrgantrans_flax_to_state_dict", "gen_rrdb_flax_to_state_dict", "gen_rpa_flax_to_state_dict",
    "encoder_layer_to_state_dict", "state_dict_to_flax",
    "discriminator_flax_to_state_dict", "sa_discriminator_flax_to_state_dict", "token_attention_to_state_dict",
    "attention_discriminator_flax_to_state_dict",
    "multiscale_attention_discriminator_flax_to_state_dict", "vgg_discriminator_flax_to_state_dict",
    "vgg19_flax_to_state_dict", "alexnet_flax_to_state_dict",
    "flatten_flax", "unflatten_flax", "load_generator_weights",
]


def _np(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _hwio_to_oihw(w: Any) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (3, 2, 0, 1)))


def _oihw_to_hwio(w: Any) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _unstack_trunk(params: dict) -> dict:
    """Scanned trunk (``ScanRRDB``) -> unrolled ``RRDB_{i}`` entries."""
    key = next((k for k in params if k.startswith("ScanRRDB")), None)
    if key is None:
        return dict(params)
    inner = next(iter(params[key].values()))

    def take(tree: dict, i: int) -> dict:
        return {k: take(v, i) if isinstance(v, dict) else _np(v)[i] for k, v in tree.items()}

    def depth(tree: Any) -> int:
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return int(_np(tree).shape[0])

    out = {k: v for k, v in params.items() if k != key}
    for i in range(depth(inner)):
        out[f"RRDB_{i}"] = take(inner, i)
    return out


def _leaves(tree: dict, prefix: str = "") -> set[str]:
    out: set[str] = set()
    for k, v in tree.items():
        out |= _leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k}
    return out


def _conv_names(params: dict) -> list[str]:
    return sorted((k for k in params if k.startswith("Conv_")), key=lambda k: int(k.split("_")[1]))


def _put_trunk(params: dict, sd: dict, used: set[str]) -> None:
    num_blocks = sum(1 for k in params if k.startswith("RRDB_"))
    if num_blocks == 0:
        raise ValueError("no RRDB_* / ScanRRDB trunk in the param tree")
    for i in range(num_blocks):
        for j in range(3):
            rdb = params[f"RRDB_{i}"][f"ResidualDenseBlock_{j}"]
            for k in range(5):
                prefix = f"trunk.{i}.rdb{j + 1}.conv{k + 1}"
                sd[f"{prefix}.weight"] = _hwio_to_oihw(rdb[f"conv{k}_kernel"])
                sd[f"{prefix}.bias"] = _np(rdb[f"conv{k}_bias"])
                used |= {f"RRDB_{i}/ResidualDenseBlock_{j}/conv{k}_{leaf}" for leaf in ("kernel", "bias")}


def _put_conv(params: dict, sd: dict, used: set[str], flax_name: str, prefix: str, bias: bool = True) -> None:
    inner = params[flax_name]["Conv_0"]
    sd[f"{prefix}.weight"] = _hwio_to_oihw(inner["kernel"])
    used.add(f"{flax_name}/Conv_0/kernel")
    if bias:
        sd[f"{prefix}.bias"] = _np(inner["bias"])
        used.add(f"{flax_name}/Conv_0/bias")


_ENCODER_LEAVES = frozenset(
    {f"MultiHeadDotProductAttention_0/{p}/{leaf}"
     for p in ("query", "key", "value", "out") for leaf in ("kernel", "bias")}
    | {f"Dense_{n}/{leaf}" for n in (0, 1) for leaf in ("kernel", "bias")}
    | {f"LayerNorm_{n}/{leaf}" for n in (0, 1) for leaf in ("scale", "bias")}
)


def encoder_layer_to_state_dict(layer: dict) -> dict[str, np.ndarray]:
    """One Flax ``TransformerEncoderLayer`` subtree -> the port's
    ``TransformerEncoderLayer`` state dict (torch's layer names)."""
    if _leaves(layer) != _ENCODER_LEAVES:
        raise ValueError(
            f"not a TransformerEncoderLayer subtree: leaves {sorted(_leaves(layer) ^ _ENCODER_LEAVES)} "
            "missing or unexpected"
        )
    mha = layer["MultiHeadDotProductAttention_0"]
    c = _np(mha["query"]["kernel"]).shape[0]
    sd = {
        "self_attn.in_proj_weight": np.concatenate(
            [_np(mha[p]["kernel"]).reshape(c, -1).T for p in ("query", "key", "value")]
        ),
        "self_attn.in_proj_bias": np.concatenate(
            [_np(mha[p]["bias"]).reshape(-1) for p in ("query", "key", "value")]
        ),
        "self_attn.out_proj.weight": np.ascontiguousarray(_np(mha["out"]["kernel"]).reshape(-1, c).T),
        "self_attn.out_proj.bias": _np(mha["out"]["bias"]),
    }
    for n in (0, 1):
        sd[f"linear{n + 1}.weight"] = np.ascontiguousarray(_np(layer[f"Dense_{n}"]["kernel"]).T)
        sd[f"linear{n + 1}.bias"] = _np(layer[f"Dense_{n}"]["bias"])
        sd[f"norm{n + 1}.weight"] = _np(layer[f"LayerNorm_{n}"]["scale"])
        sd[f"norm{n + 1}.bias"] = _np(layer[f"LayerNorm_{n}"]["bias"])
    return sd


def _refuse_unmapped(params: dict, used: set[str], family: str) -> None:
    left = sorted(_leaves(params) - used)
    if left:
        raise ValueError(
            f"the {family} mapping cannot place {len(left)} leaves of this param tree, "
            f"e.g. {left[:3]}: it is not a tree of that family"
        )


def rrdb_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """An ``RRDBNet``/``BSRGAN`` tree (unrolled or scanned trunk) ->
    reference-named numpy state dict. Raises on a tree with leaves this
    mapping does not place (a ``BSRGANtrans`` tree among them)."""
    params = _unstack_trunk(params)
    sd: dict[str, np.ndarray] = {}
    used: set[str] = set()
    rest = _conv_names(params)
    if rest[:2] != ["Conv_0", "Conv_1"] or len(rest) < 4:
        raise ValueError(f"expected conv1, conv2 and >= 2 tail convs, found {rest}")
    if _is_gen_rrdb_tree(params):
        raise ValueError("a gen_rrdb2x tree (Conv_4 is its last conv), not an RRDBNet one")
    _put_conv(params, sd, used, "Conv_0", "conv1")
    _put_trunk(params, sd, used)
    _put_conv(params, sd, used, "Conv_1", "conv2")
    tail = rest[2:]
    for u, name in enumerate(tail[:-2]):
        _put_conv(params, sd, used, name, f"upsampling{u + 1}.0")
    _put_conv(params, sd, used, tail[-2], "conv3.0")
    _put_conv(params, sd, used, tail[-1], "conv4")
    _refuse_unmapped(params, used, "RRDB-generator")
    return sd


_UNSHUFFLED_CHANNELS = (3, 12, 48)  # conv1's input at x4, x2 and x1


def realesrgan_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """A ``RealESRGANNet`` tree (unrolled or scanned trunk) -> the port's
    state dict. Raises on a tree of another layout: convs other than
    ``Conv_0..Conv_5`` (an x2 or x8 RRDBNet, a BSRGANtrans), conv1 input
    channels other than 3, 12 or 48, or leaves it does not place."""
    params = _unstack_trunk(params)
    convs = _conv_names(params)
    if convs != [f"Conv_{i}" for i in range(6)]:
        raise ValueError(f"a RealESRGANNet tree has Conv_0..Conv_5, found {convs}")
    if _is_gen_rrdb_tree(params):
        raise ValueError("a gen_rrdb2x tree (Conv_4 is its last conv), not a RealESRGANNet one")
    cin = int(_np(params["Conv_0"]["Conv_0"]["kernel"]).shape[2])
    if cin not in _UNSHUFFLED_CHANNELS:
        raise ValueError(f"a RealESRGANNet conv1 takes {_UNSHUFFLED_CHANNELS} channels, this one {cin}")
    sd: dict[str, np.ndarray] = {}
    used: set[str] = set()
    _put_trunk(params, sd, used)
    for name, prefix in zip(convs, ["conv1", "conv2", "upsampling1.0", "upsampling2.0", "conv3.0", "conv4"]):
        _put_conv(params, sd, used, name, prefix)
    _refuse_unmapped(params, used, "RealESRGANNet")
    return sd


def bsrgantrans_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """A ``BSRGANtrans`` tree (unrolled or scanned trunk) -> the port's
    state dict (names in the module docstring)."""
    params = _unstack_trunk(params)
    sd: dict[str, np.ndarray] = {}
    used: set[str] = set()
    convs = _conv_names(params)
    if convs != [f"Conv_{i}" for i in range(7)]:
        raise ValueError(f"a bsrgantrans_x2 tree has Conv_0..Conv_6, found {convs}")
    _put_conv(params, sd, used, "Conv_0", "conv1")
    _put_trunk(params, sd, used)
    for name, prefix in zip(convs[1:], ["down_conv", "up_conv", "conv2", "upsampling1.0",
                                        "conv3.0", "conv4"]):
        _put_conv(params, sd, used, name, prefix)
    layers = sorted(k for k in params if k.startswith("TransformerEncoderLayer_"))
    if layers != ["TransformerEncoderLayer_0", "TransformerEncoderLayer_1"]:
        raise ValueError(f"a bsrgantrans_x2 tree has 2 transformer layers, found {layers}")
    for i, name in enumerate(layers):
        for key, value in encoder_layer_to_state_dict(params[name]).items():
            sd[f"transformer.{i}.{key}"] = value
        used |= {f"{name}/{leaf}" for leaf in _ENCODER_LEAVES}
    _refuse_unmapped(params, used, "BSRGANtrans")
    return sd


_GEN_RRDB_NAMES = ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_last", "conv_hr")  # Conv_0..5


def _conv_out(params: dict, name: str) -> int | None:
    kernel = params.get(name, {}).get("Conv_0", {}).get("kernel")
    return None if kernel is None else int(_np(kernel).shape[3])


def _is_gen_rrdb_tree(params: dict) -> bool:
    """A tree of Conv_0..Conv_5 whose ``Conv_5`` keeps the features and whose
    ``Conv_4`` leaves them (the last conv): ``GeneratorRRDB``'s layout.
    RRDBNet x4 and RealESRGANNet trees have the same names with the two
    roles the other way round. Where the output channels equal the features
    the shapes cannot tell them apart, and this raises."""
    if _conv_names(params) != [f"Conv_{i}" for i in range(6)]:
        return False
    feat, out4, out5 = (_conv_out(params, f"Conv_{i}") for i in (0, 4, 5))
    if out4 == out5 == feat:
        raise ValueError(
            "a tree of Conv_0..Conv_5 whose output channels equal its features: "
            "gen_rrdb2x and the RealESRGANNet/RRDBNet trees share their names, and "
            "only Conv_4's or Conv_5's output channels tell them apart"
        )
    return out5 == feat != out4


def gen_rrdb_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """A ``GeneratorRRDB`` tree (``gen_rrdb2x``; unrolled or scanned trunk) ->
    the port's state dict in BasicSR's names (module docstring). Raises on
    a tree of another layout, a ``RealESRGANNet`` one among them."""
    params = _unstack_trunk(params)
    if not _is_gen_rrdb_tree(params):
        raise ValueError(f"a gen_rrdb2x tree has Conv_0..Conv_5 with Conv_4 the last conv, found "
                         f"{[(k, _conv_out(params, k)) for k in _conv_names(params)]}")
    sd: dict[str, np.ndarray] = {}
    used: set[str] = set()
    _put_trunk(params, sd, used)
    sd = {k.replace("trunk.", "body.", 1): v for k, v in sd.items()}
    for i, prefix in enumerate(_GEN_RRDB_NAMES):
        _put_conv(params, sd, used, f"Conv_{i}", prefix)
    _refuse_unmapped(params, used, "gen_rrdb2x")
    return sd


_RPA_CONVS = ("conv1", "conv2", "conv3", "conv4")  # _RPABlock_i/Conv_0..3
_US_CONVS = ("conv1", "pa_conv", "conv2")  # _PAUpsample_i/Conv_0..2


def _numbered(params: dict, stem: str) -> list[str]:
    return sorted((k for k in params if k.startswith(stem)), key=lambda k: int(k[len(stem):]))


def gen_rpa_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """A ``GeneratorRPA`` tree (``gen_rpa2x``) -> the port's state dict
    (names in the module docstring)."""
    sd: dict[str, np.ndarray] = {}
    used: set[str] = set()
    if _conv_names(params) != ["Conv_0", "Conv_1", "Conv_2"]:
        raise ValueError(f"a gen_rpa2x tree has Conv_0..Conv_2 at the top, found {_conv_names(params)}")
    try:
        for name, prefix in zip(("Conv_0", "Conv_1", "Conv_2"), ("conv1", "conv2", "conv3")):
            _put_conv(params, sd, used, name, prefix)
        for stem, module, convs in (("_RPABlock_", "rpa", _RPA_CONVS), ("_PAUpsample_", "us", _US_CONVS)):
            for i, block in enumerate(_numbered(params, stem)):
                inner: set[str] = set()
                for j, conv in enumerate(convs):
                    _put_conv(params[block], sd, inner, f"Conv_{j}", f"{module}.{i}.{conv}")
                used |= {f"{block}/{leaf}" for leaf in inner}
    except KeyError as e:
        raise ValueError(f"the gen_rpa2x mapping found no {e}: it is not a tree of that family "
                         f"(found {sorted(params)})") from None
    _refuse_unmapped(params, used, "gen_rpa2x")
    return sd


def flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """Flax generator params (unrolled or scanned trunk, nested dicts of
    arrays) -> the port's numpy state dict, through the mapping the tree's
    keys call for: the modules' names first (transformer layers, RPA
    blocks), then, among the trees of Conv_0..Conv_5 and a trunk, which of
    Conv_4 and Conv_5 is the last conv (``gen_rrdb2x``), then conv1's
    unshuffled channels (``RealESRGANNet``)."""
    if any(k.startswith("TransformerEncoderLayer_") for k in params):
        return bsrgantrans_flax_to_state_dict(params)
    if any(k.startswith(("_RPABlock_", "_PAUpsample_")) for k in params):
        return gen_rpa_flax_to_state_dict(params)
    if _is_gen_rrdb_tree(params):
        return gen_rrdb_flax_to_state_dict(params)
    conv1 = params.get("Conv_0", {}).get("Conv_0", {}).get("kernel")
    if conv1 is not None and _np(conv1).shape[2] in _UNSHUFFLED_CHANNELS[1:]:
        return realesrgan_flax_to_state_dict(params)
    return rrdb_flax_to_state_dict(params)


def discriminator_flax_to_state_dict(params: dict, spectral: dict | None) -> dict[str, np.ndarray]:
    """A ``DiscriminatorUNet`` tree (``params``) and its ``spectral``
    collection -> the port's numpy state dict, ``u`` buffers included.
    ``spectral`` None (a ``.npz`` in ``tools/port_torch_weights.py``'s
    layout, which carries no ``u``) leaves the ``u`` out."""
    sd: dict[str, np.ndarray] = {}
    used: set[str] = set()
    sn = sorted((k for k in params if k.startswith("SNConv_")), key=lambda k: int(k.split("_")[1]))
    if _conv_names(params) != ["Conv_0", "Conv_1"] or sn != [f"SNConv_{i}" for i in range(8)]:
        raise ValueError(f"a discriminator_unet tree has Conv_0, Conv_1 and SNConv_0..7, found {sorted(params)}")
    _put_conv(params, sd, used, "Conv_0", "conv0")
    for i, name in enumerate(sn):
        sd[f"conv{i + 1}.weight"] = _hwio_to_oihw(params[name]["kernel"])
        if spectral is not None:
            sd[f"conv{i + 1}.u"] = _np(spectral[name]["u"])
        used.add(f"{name}/kernel")
    _put_conv(params, sd, used, "Conv_1", "conv9")
    _refuse_unmapped(params, used, "discriminator_unet")
    if spectral is not None:
        _refuse_unmapped(spectral, {f"{name}/u" for name in sn}, "discriminator_unet spectral")
    return sd


_SA_NAMES = ("attn_down2", "attn_down3", "attn_up1")  # TokenSelfAttention_0..2
_TOKEN_ATTENTION_LEAVES = frozenset(f"{p}/{leaf}" for p in ("query", "key", "value", "out")
                                    for leaf in ("kernel", "bias"))


def token_attention_to_state_dict(tree: dict) -> dict[str, np.ndarray]:
    """One Flax ``TokenSelfAttention`` subtree (``query``/``key``/``value``
    kernels (C, H, D) and biases (H, D), ``out`` kernel (H, D, C)) -> the
    port's ``TokenSelfAttention`` state dict in ``nn.MultiheadAttention``'s
    layout, as ``encoder_layer_to_state_dict`` maps the transformer's."""
    if _leaves(tree) != _TOKEN_ATTENTION_LEAVES:
        raise ValueError(f"not a TokenSelfAttention subtree: leaves {sorted(_leaves(tree) ^ _TOKEN_ATTENTION_LEAVES)} "
                         "missing or unexpected")
    c = _np(tree["query"]["kernel"]).shape[0]
    return {
        "in_proj_weight": np.concatenate([_np(tree[p]["kernel"]).reshape(c, -1).T for p in ("query", "key", "value")]),
        "in_proj_bias": np.concatenate([_np(tree[p]["bias"]).reshape(-1) for p in ("query", "key", "value")]),
        "out_proj.weight": np.ascontiguousarray(_np(tree["out"]["kernel"]).reshape(-1, c).T),
        "out_proj.bias": _np(tree["out"]["bias"]),
    }


def sa_discriminator_flax_to_state_dict(params: dict, spectral: dict | None) -> dict[str, np.ndarray]:
    """A ``DiscriminatorUNetSA`` tree (``discriminator_unet_sa``): the U-Net's
    leaves through :func:`discriminator_flax_to_state_dict`, and
    ``TokenSelfAttention_{0,1,2}`` onto ``attn_down2``, ``attn_down3`` and
    ``attn_up1`` (the JAX module's call order)."""
    sa = {f"TokenSelfAttention_{i}" for i in range(3)}
    if not sa <= set(params):
        raise ValueError(f"a discriminator_unet_sa tree has TokenSelfAttention_0..2, found {sorted(params)}")
    sd = discriminator_flax_to_state_dict({k: v for k, v in params.items() if k not in sa}, spectral)
    for i, name in enumerate(_SA_NAMES):
        sd.update({f"{name}.{k}": v for k, v in token_attention_to_state_dict(params[f"TokenSelfAttention_{i}"]).items()})
    return sd


# the attention U-Net's top-level SN convs in the JAX module's call order
_ATTN_SN = ("conv1", "conv2", "conv3", "gating", "conv4", "conv5", "conv6", "conv7", "conv8")


def attention_discriminator_flax_to_state_dict(
    params: dict, batch_stats: dict, spectral: dict | None
) -> dict[str, np.ndarray]:
    """An ``AttentionUNetDiscriminator`` tree (``params``) and its
    ``batch_stats`` and ``spectral`` collections -> the port's numpy state
    dict, the gates' running statistics and every ``u`` included
    (``spectral`` None, a ``.npz`` source's: no ``u``)."""
    sd: dict[str, np.ndarray] = {}
    used, used_stats, used_u = set(), set(), set()

    def sn(flax_name: str, prefix: str) -> None:
        sd[f"{prefix}.weight"] = _hwio_to_oihw(_get(params, flax_name)["kernel"])
        if spectral is not None:
            sd[f"{prefix}.u"] = _np(_get(spectral, flax_name)["u"])
        used.add(f"{flax_name}/kernel")
        used_u.add(f"{flax_name}/u")

    try:
        _put_conv(params, sd, used, "Conv_0", "conv0")
        _put_conv(params, sd, used, "Conv_1", "conv9")
        for i, name in enumerate(_ATTN_SN):
            sn(f"SNConv_{i}", name)
        for i in range(3):
            gate, prefix = f"_AddAttn_{i}", f"attn_{i + 1}"
            used_gate: set[str] = set()
            for j, conv in enumerate(("theta", "phi", "psi", "W.0")):  # theta has no bias
                _put_conv(params[gate], sd, used_gate, f"Conv_{j}", f"{prefix}.{conv}", bias=j > 0)
            used |= {f"{gate}/{leaf}" for leaf in used_gate}
            bn = params[gate]["BatchNorm_0"]
            stats = batch_stats[gate]["BatchNorm_0"]
            sd[f"{prefix}.W.1.weight"], sd[f"{prefix}.W.1.bias"] = _np(bn["scale"]), _np(bn["bias"])
            sd[f"{prefix}.W.1.running_mean"], sd[f"{prefix}.W.1.running_var"] = _np(stats["mean"]), _np(stats["var"])
            used |= {f"{gate}/BatchNorm_0/scale", f"{gate}/BatchNorm_0/bias"}
            used_stats |= {f"{gate}/BatchNorm_0/mean", f"{gate}/BatchNorm_0/var"}
            sn(f"_UNetCat_{i}/SNConv_0", f"cat_{i + 1}.convU")
    except KeyError as e:
        raise ValueError(f"the attention U-Net discriminator mapping found no {e}: it is not a tree of that "
                         f"family (found {sorted(params)})") from None
    _refuse_unmapped(params, used, "attention U-Net discriminator")
    _refuse_unmapped(batch_stats, used_stats, "attention U-Net discriminator batch_stats")
    if spectral is not None:
        _refuse_unmapped(spectral, used_u, "attention U-Net discriminator spectral")
    return sd


def multiscale_attention_discriminator_flax_to_state_dict(
    params: dict, batch_stats: dict, spectral: dict | None
) -> dict[str, np.ndarray]:
    """A ``MultiScaleAttentionDiscriminator`` tree: each scale's ``D{s}``
    through :func:`attention_discriminator_flax_to_state_dict`, its names
    prefixed ``D{s}.``."""
    scales = [f"D{s}" for s in range(len(params))]
    if sorted(params) != sorted(scales):
        raise ValueError(f"the multi-scale attention discriminator mapping takes D0..D{{n-1}}, found {sorted(params)}")
    return {f"{d}.{k}": v for d in scales for k, v in attention_discriminator_flax_to_state_dict(
        params[d], batch_stats.get(d, {}), None if spectral is None else spectral.get(d, {})).items()}


_VGG_CONVS = (0, 2, 5, 8, 11, 14, 17, 20, 23, 26)  # features.N of Conv_0..9; BatchNorm_i is features.{3 + 3i}


def vgg_discriminator_flax_to_state_dict(params: dict, batch_stats: dict) -> dict[str, np.ndarray]:
    """A ``DiscriminatorVGG128`` tree (``params``) and its ``batch_stats``
    collection -> the port's numpy state dict, running statistics
    included."""
    sd: dict[str, np.ndarray] = {}
    used, used_stats = set(), set()
    try:
        for i, n in enumerate(_VGG_CONVS):
            _put_conv(params, sd, used, f"Conv_{i}", f"features.{n}", bias=i == 0)
        for i in range(len(_VGG_CONVS) - 1):
            bn, stats, prefix = params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"], f"features.{3 + 3 * i}"
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _np(bn["scale"]), _np(bn["bias"])
            sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = _np(stats["mean"]), _np(stats["var"])
            used |= {f"BatchNorm_{i}/scale", f"BatchNorm_{i}/bias"}
            used_stats |= {f"BatchNorm_{i}/mean", f"BatchNorm_{i}/var"}
        for i, n in enumerate((0, 2)):
            dense = params[f"Dense_{i}"]
            sd[f"classifier.{n}.weight"] = np.ascontiguousarray(_np(dense["kernel"]).T)
            sd[f"classifier.{n}.bias"] = _np(dense["bias"])
            used |= {f"Dense_{i}/kernel", f"Dense_{i}/bias"}
    except KeyError as e:
        raise ValueError(f"the VGG-128 discriminator mapping found no {e}: it is not a tree of that family "
                         f"(found {sorted(params)})") from None
    _refuse_unmapped(params, used, "VGG-128 discriminator")
    _refuse_unmapped(batch_stats, used_stats, "VGG-128 discriminator batch_stats")
    return sd


def _get(tree: dict, path: str) -> dict:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _named_convs_to_state_dict(params: dict, prefix: str, family: str) -> dict[str, np.ndarray]:
    """``conv{i}/{kernel,bias}`` -> ``{prefix}.{i}.weight`` (OIHW) and ``.bias``."""
    sd: dict[str, np.ndarray] = {}
    for name, leaves in params.items():
        if not name.startswith("conv") or set(leaves) != {"kernel", "bias"}:
            raise ValueError(f"the {family} mapping cannot place {name!r}: it is not a tree of that family")
        i = int(name[len("conv"):])
        sd[f"{prefix}.{i}.weight"] = _hwio_to_oihw(leaves["kernel"])
        sd[f"{prefix}.{i}.bias"] = _np(leaves["bias"])
    return sd


def vgg19_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """The JAX ``VGG19Features`` params -> the port's (``features.{i}``)."""
    return _named_convs_to_state_dict(params, "features", "VGG19")


def alexnet_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """The JAX ``AlexNetFeatures`` params -> the port's (``alex.{i}``)."""
    return _named_convs_to_state_dict(params, "alex", "AlexNet")


def _encoder_layer_to_flax(sd: dict[str, Any], prefix: str) -> dict:
    """Inverse of :func:`encoder_layer_to_state_dict` for the keys under
    ``prefix``."""
    nhead = 4  # BSRGANtrans's heads; the state dict does not record them
    w_in = _np(sd[f"{prefix}self_attn.in_proj_weight"])
    b_in = _np(sd[f"{prefix}self_attn.in_proj_bias"])
    c = w_in.shape[1]
    mha = {}
    for i, p in enumerate(("query", "key", "value")):
        mha[p] = {"kernel": np.ascontiguousarray(w_in[i * c : (i + 1) * c].T).reshape(c, nhead, -1),
                  "bias": b_in[i * c : (i + 1) * c].reshape(nhead, -1)}
    mha["out"] = {
        "kernel": np.ascontiguousarray(_np(sd[f"{prefix}self_attn.out_proj.weight"]).T)
        .reshape(nhead, -1, c),
        "bias": _np(sd[f"{prefix}self_attn.out_proj.bias"]),
    }
    layer: dict[str, Any] = {"MultiHeadDotProductAttention_0": mha}
    for n in (0, 1):
        layer[f"Dense_{n}"] = {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}linear{n + 1}.weight"]).T),
                               "bias": _np(sd[f"{prefix}linear{n + 1}.bias"])}
        layer[f"LayerNorm_{n}"] = {"scale": _np(sd[f"{prefix}norm{n + 1}.weight"]),
                                   "bias": _np(sd[f"{prefix}norm{n + 1}.bias"])}
    return layer


def _gen_rpa_to_flax(sd: dict[str, Any], conv) -> dict:
    """Inverse of :func:`gen_rpa_flax_to_state_dict`."""
    params: dict[str, Any] = {f"Conv_{i}": conv(p) for i, p in enumerate(("conv1", "conv2", "conv3"))}
    for stem, module, convs in (("_RPABlock_", "rpa", _RPA_CONVS), ("_PAUpsample_", "us", _US_CONVS)):
        count = len({k.split(".")[1] for k in sd if k.startswith(f"{module}.")})
        for i in range(count):
            params[f"{stem}{i}"] = {f"Conv_{j}": conv(f"{module}.{i}.{c}") for j, c in enumerate(convs)}
    return params


def state_dict_to_flax(sd: dict[str, Any], num_blocks: int, scan_blocks: bool = False) -> dict:
    """Inverse of :func:`flax_to_state_dict`: the Flax param tree with an
    unrolled trunk, or the ``ScanRRDB`` layout with ``scan_blocks=True``.
    A state dict with ``transformer.*`` keys gives a ``BSRGANtrans`` tree,
    one with ``conv_first`` a ``GeneratorRRDB`` tree and one with ``rpa.*``
    keys a ``GeneratorRPA`` tree (``num_blocks`` unused)."""

    def conv(prefix: str) -> dict:
        return {"Conv_0": {"kernel": _oihw_to_hwio(sd[f"{prefix}.weight"]),
                           "bias": _np(sd[f"{prefix}.bias"])}}

    if any(k.startswith("rpa.") for k in sd):
        return _gen_rpa_to_flax(sd, conv)
    gen_rrdb = "conv_first.weight" in sd
    trunk = "body" if gen_rrdb else "trunk"
    params: dict[str, Any] = {"Conv_0": conv("conv_first" if gen_rrdb else "conv1")}
    blocks = []
    for i in range(num_blocks):
        block = {}
        for j in range(3):
            rdb = {}
            for k in range(5):
                prefix = f"{trunk}.{i}.rdb{j + 1}.conv{k + 1}"
                rdb[f"conv{k}_kernel"] = _oihw_to_hwio(sd[f"{prefix}.weight"])
                rdb[f"conv{k}_bias"] = _np(sd[f"{prefix}.bias"])
            block[f"ResidualDenseBlock_{j}"] = rdb
        blocks.append(block)
    if scan_blocks:
        params["ScanRRDB"] = {"RRDB_0": {
            rdb: {leaf: np.stack([b[rdb][leaf] for b in blocks]) for leaf in blocks[0][rdb]}
            for rdb in blocks[0]
        }}
    else:
        params.update({f"RRDB_{i}": b for i, b in enumerate(blocks)})
    if gen_rrdb:
        params.update({f"Conv_{i}": conv(p) for i, p in enumerate(_GEN_RRDB_NAMES) if i})
        return params
    n_up = sum(1 for k in sd if k.startswith("upsampling") and k.endswith(".0.weight"))
    tail = [f"upsampling{u + 1}.0" for u in range(n_up)] + ["conv3.0", "conv4"]
    if any(k.startswith("transformer.") for k in sd):
        head = ["down_conv", "up_conv", "conv2"]
        for i in range(2):
            params[f"TransformerEncoderLayer_{i}"] = _encoder_layer_to_flax(sd, f"transformer.{i}.")
    else:
        head = ["conv2"]
    for n, prefix in enumerate(head + tail, start=1):
        params[f"Conv_{n}"] = conv(prefix)
    return params


def flatten_flax(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested Flax tree as ``/``-joined key paths, in the tree's order
    (the JAX export's and ``tools/port_torch_weights.py``'s flat layout)."""
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_flax(v, name))
        else:
            flat[name] = np.asarray(v)
    return flat


def unflatten_flax(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_generator_weights(path: str, use_ema: bool = False) -> dict[str, torch.Tensor]:
    """Reference-named generator state dict from

    - a ``.pth``/``.pt``: ``{"state_dict": ...}`` as ``tools/export_to_torch.py``
      writes it, a checkpoint of ``cli.train`` (``state_dict`` and
      ``ema_state_dict``), or a bare state dict;
    - a ``.npz`` of the Flax tree with '/'-joined key paths, either the
      generator's params or a state holding ``g_params``/``ema_g_params``.

    ``use_ema`` picks ``ema_g_params`` (``ema_state_dict``) where the file
    holds both; a file that holds one set of weights cannot honour it and
    raises.
    """
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint?): reading Orbax needs "
            "JAX. Convert it with `python tools/export_to_torch.py --arch <arch> "
            "--ckpt <dir> --key g_params|ema_g_params --out weights.pth`."
        )
    if path.endswith(".npz"):
        with np.load(path) as f:
            tree = unflatten_flax({k: f[k] for k in f.files})
        if "g_params" in tree:
            tree = tree["ema_g_params" if use_ema else "g_params"]
        elif use_ema:
            raise ValueError(f"--use-ema: {path} holds no ema_g_params")
        return {k: torch.from_numpy(v) for k, v in flax_to_state_dict(tree).items()}
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if use_ema:
        if "ema_state_dict" not in payload:
            raise ValueError(
                f"--use-ema: {path} holds one set of weights; export the EMA one with "
                "`tools/export_to_torch.py --key ema_g_params`"
            )
        return payload["ema_state_dict"]
    return payload.get("state_dict", payload)
