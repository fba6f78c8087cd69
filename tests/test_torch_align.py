"""The port's fuzzy checkpoint aligner (models/params_io.py::
align_state_dict) and `train/checkpoint.py::load_reference_pth` against
the JAX package's align_params / import_checkpoint(_aligned), on the nine
cases of tests/test_align_params.py.

Each case is a pair of torch state dicts with the reference's names, made
here. The JAX side gets them through torch_to_flax_params key by key (an
outer prefix before the reference name kept, a bare backbone key without
its `backbone` level; a 2-D conv kernel through the module's 2-D
transpose, which torch_to_flax_params lacks). The port's aligned state
dict, mapped the same way, must equal the JAX aligned tree value for
value, and the port's five report lists, their keys mapped, must equal
the JAX lists. Nothing is downloaded.
"""

import re

import numpy as np
import pytest
import torch

from brainfm_tpu.models.torch_import import (_conv_w_2d, align_params,
                                             flatten_params,
                                             import_checkpoint,
                                             import_checkpoint_aligned,
                                             torch_to_flax_params)
from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.models import build_model
from brainfm_tpu_torch.models.params_io import align_state_dict
from brainfm_tpu_torch.train.checkpoint import load_reference_pth

CONV = "backbone.encoders.0.basic_module.SingleConv1.conv"
BARE = "encoders.0.basic_module.SingleConv1.conv"
_CORE = re.compile(r"(?:^|\.)(backbone\.|head\.|encoders\.|decoders)")


def _t(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _flax_item(key, value):
    """(flax key, numpy value) of one reference-named torch entry."""
    pos = _CORE.search(key).start(1)
    outer, core = key[:pos], key[pos:]
    a = value.numpy()
    if a.ndim == 4 and core.endswith("conv.weight"):   # a 2-D kernel
        stand_in = np.zeros(a.shape[:2] + (1,) + a.shape[2:], a.dtype)
        (fk, _), = flatten_params(torch_to_flax_params({core: stand_in})
                                  ).items()
        fv = _conv_w_2d(a)
    else:
        (fk, fv), = flatten_params(torch_to_flax_params({core: a})).items()
    if not core.startswith(("backbone.", "head.")):
        fk = fk.removeprefix("backbone.")
    return outer + fk, np.asarray(fv).astype(a.dtype)


def _tree(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flax_flat(sd):
    return dict(_flax_item(k, v) for k, v in sd.items())


def _check(target, ckpt, **kw):
    """Align on both sides; assert the same values and reports. Returns
    the port's (aligned, report)."""
    got, rep = align_state_dict(target, ckpt, **kw)
    want_tree, want_rep = align_params(_tree(_flax_flat(target)),
                                       _tree(_flax_flat(ckpt)), **kw)
    want = flatten_params(want_tree)
    mapped = _flax_flat(got)
    assert set(mapped) == set(want)
    for k, v in want.items():
        assert mapped[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(mapped[k], np.asarray(v), err_msg=k)
    names = {k: _flax_item(k, v)[0] for k, v in {**ckpt, **target}.items()}
    for name, lst in rep.items():
        ported = [tuple(names[k] for k in e) if isinstance(e, tuple)
                  else names[e] for e in lst]
        assert ported == [tuple(e) if isinstance(e, tuple) else e
                          for e in want_rep[name]], name
    return got, rep


def test_exact_and_suffix_match():
    # the checkpoint lacks the outer 'backbone.' prefix: a suffix match
    target = {f"{CONV}.weight": _t((8, 1, 3, 3, 3), 0),
              f"{CONV}.bias": _t((8,), 1)}
    ckpt = {f"{BARE}.weight": _t((8, 1, 3, 3, 3), 2),
            f"{BARE}.bias": _t((8,), 3)}
    got, rep = _check(target, ckpt)
    assert torch.equal(got[f"{CONV}.weight"], ckpt[f"{BARE}.weight"])
    assert len(rep["matched"]) == 2 and not rep["unmatched_ckpt"]


def test_longest_match_wins():
    target = {f"{CONV}.bias": _t((4,), 0)}
    ckpt = {f"{CONV}.bias": _t((4,), 1), f"{BARE}.bias": _t((4,), 2)}
    got, rep = _check(target, ckpt)
    assert torch.equal(got[f"{CONV}.bias"], ckpt[f"{CONV}.bias"])
    assert rep["unmatched_ckpt"] == [f"{BARE}.bias"]


def test_exclude_key_keeps_target():
    seg, t1 = "head.final_conv_segmentation.weight", "head.final_conv_T1.weight"
    target = {seg: _t((4, 8, 1, 1, 1), 0), t1: _t((1, 8, 1, 1, 1), 1)}
    ckpt = {seg: _t((4, 8, 1, 1, 1), 2), t1: _t((1, 8, 1, 1, 1), 3)}
    got, rep = _check(target, ckpt, exclude_key="segmentation")
    assert torch.equal(got[seg], target[seg])
    assert torch.equal(got[t1], ckpt[t1])
    assert seg not in [m for m, _ in rep["matched"]]


def test_to_match_rename():
    target = {"head.final_conv_T2.weight": _t((1, 8, 1, 1, 1), 0)}
    ckpt = {"head.final_conv_T1.weight": _t((1, 8, 1, 1, 1), 1)}
    got, _ = _check(target, ckpt,
                    to_match={"final_conv_T1": "final_conv_T2"})
    assert torch.equal(got["head.final_conv_T2.weight"],
                       ckpt["head.final_conv_T1.weight"])


def test_2d_to_3d_center_frame_inflation():
    k2 = _t((4, 2, 3, 3), 0)
    target = {f"{CONV}.weight": torch.ones(4, 2, 3, 3, 3)}
    got, rep = _check(target, {f"{CONV}.weight": k2})
    k3 = got[f"{CONV}.weight"]
    assert torch.equal(k3[:, :, 1], k2)
    assert not k3[:, :, 0].any() and not k3[:, :, 2].any()
    assert rep["inflated"] == [(f"{CONV}.weight", f"{CONV}.weight")]


def test_same_rank_mismatch_skipped():
    target = {f"{CONV}.weight": _t((8, 4, 3, 3, 3), 0)}
    got, rep = _check(target, {f"{CONV}.weight": _t((6, 4, 3, 3, 3), 1)})
    assert torch.equal(got[f"{CONV}.weight"], target[f"{CONV}.weight"])
    assert rep["skipped_shape"] == [(f"{CONV}.weight", f"{CONV}.weight")]
    assert rep["unmatched_model"] == [f"{CONV}.weight"]


def test_ambiguous_match_raises():
    target = {"x.head.final_conv_T1.weight": _t((1, 8, 1, 1, 1), 0),
              "y.head.final_conv_T1.weight": _t((1, 8, 1, 1, 1), 1)}
    ckpt = {"head.final_conv_T1.weight": _t((1, 8, 1, 1, 1), 2)}
    with pytest.raises(ValueError, match="multiple keys"):
        align_params(_tree(_flax_flat(target)), _tree(_flax_flat(ckpt)))
    with pytest.raises(ValueError, match="multiple keys"):
        align_state_dict(target, ckpt)


def _small_joiner(seed):
    torch.manual_seed(seed)
    return build_model(AttrDict.from_nested({
        "task": {"T1": True}, "generator": {"left_hemis_only": False,
                                            "size": [16, 16, 16]},
        "losses": {"uncertainty": None}, "backbone": "unet3d", "f_maps": 8,
        "num_levels": 2, "num_groups": 8, "layer_order": "gcl",
        "unit_feat": False, "task_f_maps": [8]}), device="cpu")[1]


def test_import_checkpoint_aligned_partial(tmp_path):
    """A .pth holding the backbone only loads it and leaves the head's
    live values, as the JAX import_checkpoint_aligned on the same file."""
    live = _small_joiner(0).state_dict()
    other = _small_joiner(1).state_dict()
    path = str(tmp_path / "partial.pth")
    torch.save({"model": {k: v for k, v in other.items()
                          if k.startswith("backbone.")}}, path)
    got = load_reference_pth(path, target=_small_joiner(0))
    assert set(got) == set(live)
    want = flatten_params(import_checkpoint_aligned(
        path, {"params": _tree(_flax_flat(live))})["params"])
    mapped = _flax_flat(got)
    assert set(mapped) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(mapped[k], np.asarray(v), err_msg=k)
    for k in got:
        src = other if k.startswith("backbone.") else live
        assert torch.equal(got[k], src[k]), k
    # and through the aligner's report, on the same dicts
    _check(live, {k: v for k, v in other.items()
                  if k.startswith("backbone.")})


def test_inflation_casts_to_target_dtype():
    k2 = _t((4, 2, 3, 3), 0)
    target = {f"{CONV}.weight": torch.ones(4, 2, 3, 3, 3,
                                           dtype=torch.float64)}
    got, _ = _check(target, {f"{CONV}.weight": k2})
    k3 = got[f"{CONV}.weight"]
    assert k3.dtype == torch.float64
    assert torch.equal(k3[:, :, 1], k2.double())


def test_load_reference_pth_without_target(tmp_path):
    """The file's state dict, unwrapped: a `module.` prefix stripped and
    a bare backbone under `backbone.`, as the JAX import_checkpoint maps
    it."""
    sd = _small_joiner(2).state_dict()
    for name, saved in (("joiner", {"model": {f"module.{k}": v
                                              for k, v in sd.items()}}),
                        ("bare", {k.removeprefix("backbone."): v
                                  for k, v in sd.items()
                                  if k.startswith("backbone.")})):
        path = str(tmp_path / f"{name}.pth")
        torch.save(saved, path)
        got = load_reference_pth(path)
        want = flatten_params(import_checkpoint(path)["params"])
        mapped = _flax_flat(got)
        assert set(mapped) == set(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(mapped[k], np.asarray(v))
        for k, v in got.items():
            assert torch.equal(v, sd[k]), k


def test_load_reference_pth_exclude_key_keeps_live(tmp_path):
    live = _small_joiner(0)
    other = _small_joiner(3).state_dict()
    path = str(tmp_path / "full.pth")
    torch.save(other, path)
    got = load_reference_pth(path, target=live, exclude_key="final_conv_T1")
    want = flatten_params(import_checkpoint_aligned(
        path, {"params": _tree(_flax_flat(live.state_dict()))},
        exclude_key="final_conv_T1")["params"])
    mapped = _flax_flat(got)
    for k, v in want.items():
        np.testing.assert_array_equal(mapped[k], np.asarray(v), err_msg=k)
    for k, v in got.items():
        src = live.state_dict() if "final_conv_T1" in k else other
        assert torch.equal(v, src[k]), k
    live.load_state_dict(got)


def test_load_reference_pth_2d_file_into_3d_target(tmp_path):
    """A 2-D kernel in the file fills the 3-D target's centre depth frame
    (the JAX loader's import path has no 2-D transpose, so this case is
    held to the rule itself)."""
    model = _small_joiner(0)
    sd = model.state_dict()
    file_sd = {k: (v[:, :, 1].clone() if v.dim() == 5 and
                   v.shape[2] == 3 else v.clone())
               for k, v in _small_joiner(4).state_dict().items()}
    path = str(tmp_path / "two_d.pth")
    torch.save({"model": file_sd}, path)
    got = load_reference_pth(path, target=model)
    n_inflated = 0
    for k, v in got.items():
        if file_sd[k].dim() == 4 and sd[k].dim() == 5:
            n_inflated += 1
            assert torch.equal(v[:, :, 1], file_sd[k])
            assert not v[:, :, 0].any() and not v[:, :, 2].any()
        else:
            assert torch.equal(v, file_sd[k]), k
    assert n_inflated > 0
    model.load_state_dict(got)
