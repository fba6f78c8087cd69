"""High-level inference API (port of brainfm_tpu/infer/api.py).

Parity with the reference's utils/test_utils.py:290-405 (`evaluate_image`,
`evaluate_path`) and :45-57 (`get_deformed_atlas`): the model is built and
loaded once per Inferencer and serves every call. Nothing is compiled:
PyTorch runs eagerly, so the JAX package's separate jits of the forward and
of `postprocess` have no counterpart. The deformed atlas is a K1 warp
(ops/warp.py::warp_volume) and the label map a K2 lookup (in `postprocess`).
`TwoStageInferencer` serves the two-stage pair (stage-0 mask, masked
mask-conditioned stage 1) the same way.

`mesh=` (parallel/mesh.py, one process per rank) serves across GPUs: a
'space' axis splits each volume's D axis into slabs (parallel/spatial.py;
the outputs are gathered whole on every rank), and `evaluate_batch` runs
one volume per 'data' rank. Every rank holds the same weights.
"""

from __future__ import annotations

import contextlib
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import exact_fp32, resolve_device
from ..models.build import (build_inpaint_model, build_model, postprocess,
                            process_outputs)
from ..models.params_io import from_jax_params, load_pth
from ..parallel.mesh import axis_index, axis_size, local_slice
from ..parallel.spatial import gather_outputs, slab_of, space_scope
from ..train import orbax_read
from ..train.checkpoint import (MODEL_FILE, load_model_weights,
                                resolve_checkpoint)
from ..train.orbax_read import is_orbax_dir
from ..ops.warp import warp_volume
from ..utils.nifti import MRIread, viewVolume
from ..utils.profiling import annotate, count, within
from .prepare import prepare_image
from .tiles import tiled_apply

_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


class Inferencer:
    """Build once, load once, evaluate many.

    compute_dtype: float32; bfloat16 (`torch.autocast` around the model
    only: the heads' outputs are lifted to fp32 before the output
    processors and `postprocess`); float64 (a double model, for tests).
    exact: TF32 off for this Inferencer's calls (`device.exact_fp32`), the
    counterpart of the JAX package's `highest` matmul precision, which it
    also scopes to one Inferencer rather than setting it process-wide.
    ckpt_path: a `.pth` / `.pt` state dict (`models.params_io.load_pth`),
    a checkpoint directory of `train/checkpoint.py` or an orbax step
    directory of the JAX package (its params only, loaded strictly), or a
    run's ckp/ root holding either (its newest step); a directory with no
    checkpoint raises FileNotFoundError. Without one the weights are
    random, from seed 0, alike on every device.
    mesh: a DeviceMesh of parallel.make_mesh: its 'space' axis shards each
    volume's D axis over the ranks (the deep levels that do not split
    run whole), its 'data' axis takes one volume per rank in
    evaluate_batch; a data-only mesh serves a single volume whole on
    every rank, as the JAX package replicates it.
    """

    def __init__(self, cfg, ckpt_path: str | None = None,
                 compute_dtype=torch.float32, exact: bool = True,
                 device=None, mesh=None):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: one of "
                             f"{_DTYPES}")
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.exact = exact
        self.mesh = mesh
        # parameters are initialised on the CPU and then moved, so one seed
        # gives every device the same weights
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.cfg, self.model = self._build(cfg)
        if compute_dtype == torch.float64:
            self.model.double()
        self._load(ckpt_path)
        self.model.eval()
        self._in_dtype = (torch.float64 if compute_dtype == torch.float64
                          else torch.float32)

    def _build(self, cfg):
        return build_model(cfg, device=self.device)

    def _load(self, ckpt_path):
        if ckpt_path and str(ckpt_path).endswith((".pth", ".pt")):
            load_pth(self.model, str(ckpt_path))
        elif ckpt_path:
            load_model_weights(resolve_checkpoint(ckpt_path), self.model)

    def _as_input(self, x):
        return torch.as_tensor(x).to(self.device, self._in_dtype)

    def _precision(self):
        return exact_fp32() if self.exact else contextlib.nullcontext()

    def _forward(self, x, keep_feat: bool = True):
        """Model + output processors on x (B,D,H,W,1). keep_feat=False drops
        the decoder feature pyramids as soon as the heads have run. Under
        a mesh with a 'space' axis the model runs on this rank's D slab
        and its outputs are gathered whole."""
        bf16 = self.compute_dtype == torch.bfloat16
        with self._precision():
            with space_scope(self.mesh) as sc, \
                    torch.autocast(self.device.type, dtype=torch.bfloat16,
                                   enabled=bf16):
                out = self.model(x if sc is None else slab_of(x, sc))
            if not keep_feat:
                out = {k: v for k, v in out.items()
                       if not k.startswith("feat")}
            if sc is not None:
                out = gather_outputs(out, sc)
            if bf16:
                out = {k: v if k.startswith("feat") else v.float()
                       for k, v in out.items()}
            return process_outputs(self.model, out, self.cfg)

    def _post(self, out, x):
        return postprocess(out, self.cfg, samples={"input": x})

    @torch.inference_mode()
    def evaluate_image(self, inputs, feature_only: bool = False,
                       run_postprocess: bool = True, keep_feat: bool = True):
        """inputs: (B, D, H, W, 1) or (D, H, W) (parity:
        test_utils.py:290-312). keep_feat=False leaves the decoder feature
        maps out of the result: the memory headroom that lets a 220^3
        whole volume of the L6 flagship run in one pass."""
        keep_feat = keep_feat or feature_only
        x = self._as_input(inputs)
        if x.dim() == 3:
            x = x[None, ..., None]
        out = self._forward(x, keep_feat=keep_feat)
        if feature_only:
            return out["feat"][-1]
        return self._post(out, x) if run_postprocess else out

    def _data(self):
        """(data ranks, this rank's data index); (1, 0) without a mesh."""
        if self.mesh is None:
            return 1, 0
        return axis_size(self.mesh, "data"), axis_index(self.mesh, "data")

    def _local_batch(self, x, run_postprocess, keep_feat):
        """This data rank's share of a batch through the model (and
        postprocess)."""
        n, r = self._data()
        if x.shape[0] % n:
            raise ValueError(
                f"batch of {x.shape[0]} volumes cannot shard over the "
                f"mesh 'data' axis of size {n} — pass a multiple "
                "(evaluate_path pads its groups for you)")
        x = local_slice(x, n, r, 0)
        out = self._forward(x, keep_feat=keep_feat)
        return self._post(out, x) if run_postprocess else out

    @torch.inference_mode()
    def evaluate_batch(self, vols, run_postprocess: bool = True,
                       keep_feat: bool = False):
        """B same-shape whole volumes (B,D,H,W[,1]) in one pass. With a
        mesh, one volume per 'data' rank (B a multiple of the axis), and
        every rank returns the whole batch's outputs."""
        x = self._as_input(vols)
        if x.dim() == 4:
            x = x[..., None]
        if x.dim() != 5:
            raise ValueError(f"expected (B,D,H,W[,1]), got {tuple(x.shape)}")
        out = self._local_batch(x, run_postprocess, keep_feat)
        if self._data()[0] == 1:
            return out
        group = self.mesh.get_group("data")

        def gather(v):
            parts = [torch.empty_like(v) for _ in range(self._data()[0])]
            torch.distributed.all_gather(parts, v.contiguous(), group=group)
            return torch.cat(parts)

        return {k: [gather(f) for f in v] if isinstance(v, list)
                else gather(v) for k, v in out.items()}

    @torch.inference_mode()
    def evaluate_tiled(self, vol, stride=(80, 80, 80),
                       win_size=(160, 160, 160), run_postprocess: bool = True,
                       fused: bool = True, accum_dtype=torch.float32):
        """Whole volume (D,H,W) through tiles + overlap blending (parity:
        demo_test.test_tile, scripts/demo_test.py:66-119). `fused` chose the
        JAX package's one-dispatch scan; the port has one walk
        (tiles.tiled_apply), so it has no effect here. accum_dtype: fp32
        (default) blends as the reference does."""
        del fused
        vol = self._as_input(vol)
        outs = tiled_apply(lambda _, tile: self._forward(tile, False), None,
                           vol, stride, win_size, accum_dtype)
        if run_postprocess:
            outs = self._post({k: v[None] for k, v in outs.items()},
                              vol[None, ..., None])
            outs = {k: v[0] if v.dim() >= 4 else v for k, v in outs.items()}
        return outs

    def get_feature(self, img_path_or_vol, win_size=None):
        """Last decoder feature map (parity:
        scripts/demo_get_feature.py:27-44)."""
        if isinstance(img_path_or_vol, str):
            im, _, _, _ = prepare_image(img_path_or_vol, win_size,
                                        device=self.device)
        else:
            im = img_path_or_vol
        return self.evaluate_image(im, feature_only=True)

    def fetch_outputs(self, outs, exclude_keys):
        """Device -> host copies of the outputs to write, as numpy arrays;
        the device tensors can go as soon as this returns. From CUDA the
        copies go into page-locked buffers, all queued before one wait
        (a copy into pageable memory is staged and runs several times
        slower); PyTorch's host allocator keeps the buffers for the next
        volume. The span `serve.fetch`."""
        with annotate("serve.fetch"):
            sel = {k: v for k, v in outs.items()
                   if k not in exclude_keys and not k.startswith("feat")}
            if self.device.type != "cuda":
                return {k: v.numpy() for k, v in sel.items()}
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    .copy_(v, non_blocking=True) for k, v in sel.items()}
            count("host_syncs")
            torch.cuda.current_stream(self.device).synchronize()
            return {k: v.numpy() for k, v in host.items()}

    def _writes(self) -> bool:
        """Whether this rank writes a served volume: rank 0 of a mesh (its
        ranks compute the same outputs), or the one process."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _out_dir(self, save_dir, path):
        """Per-input output directory: save_dir/<basename without .nii*>.
        The serial and batched pipelines write one input to one place."""
        return os.path.join(save_dir, os.path.basename(path).split(".nii")[0])

    def _write_outputs(self, host, aff, out_dir, ext):
        """Encode host arrays to NIfTI on a small thread pool; every output
        but the registration coordinates is clipped at 0. The span
        `serve.write`."""
        def _write_one(item):
            key, val = item
            arr = np.asarray(val)[0]
            arr = np.clip(arr, 0.0, None) if key not in (
                "regx", "regy", "regz") else arr
            viewVolume(arr.squeeze(), aff, names=[f"out_{key}"], ext=ext,
                       save_dir=out_dir)

        with annotate("serve.write"), ThreadPoolExecutor(max_workers=4) as ex:
            list(ex.map(_write_one, host.items()))

    def _prepare(self, path, win_size):
        return prepare_image(path, list(win_size), device=self.device)

    def evaluate_path(self, input_paths, save_dir, win_size=(220, 220, 220),
                      exclude_keys=(), ext=".nii.gz", save_input=False,
                      prefetch: bool = True, batch_size: int = 1):
        """Serve files and write each output as NIfTI under
        save_dir/<input name>/out_<key><ext> (parity:
        test_utils.py:354-405).

        prefetch (default): double-buffered. Volume n+1 is read and prepared
        on a host thread while volume n computes, and the writes of volume n
        run on a writer thread while n+1 computes. The device -> host copy
        of volume n stays on the calling thread, before n+1 starts, so one
        volume's outputs at a time are on the device. Same outputs as the
        serial walk; a failure in any stage raises.

        batch_size > 1: groups of volumes through evaluate_batch, bucketed
        by shape within a group (center_crop passes volumes smaller than
        win_size through uncropped), one pass per bucket.

        Each input path is the span `serve.volume` (a unit of work,
        utils/profiling.py) over `serve.read`, `serve.prepare`,
        `serve.forward` (evaluate_image), `serve.fetch` and `serve.write`,
        on whichever thread runs each."""
        input_paths = list(input_paths)
        if batch_size > 1 and input_paths:
            return self._evaluate_path_batched(
                input_paths, save_dir, win_size, exclude_keys, ext,
                save_input, batch_size, prefetch)
        results = []
        writes = self._writes()
        if not prefetch or len(input_paths) <= 1:
            for p in input_paths:
                with annotate("serve.volume", unit=True):
                    im, aff, _, _ = self._prepare(p, win_size)
                    out_dir = self._out_dir(save_dir, p)
                    if writes:
                        os.makedirs(out_dir, exist_ok=True)
                    if save_input and writes:
                        count("host_syncs")
                        viewVolume(im.cpu().numpy(), aff, names=["input"],
                                   ext=ext, save_dir=out_dir)
                    with annotate("serve.forward"):
                        outs = self.evaluate_image(im, keep_feat=False)
                    host = self.fetch_outputs(outs, exclude_keys)
                    del outs
                    if writes:
                        self._write_outputs(host, aff, out_dir, ext)
                results.append(out_dir)
            return results

        def load_one(vol, p):
            with within(vol):
                return self._prepare(p, win_size)

        def write_one(vol, host, aff, out_dir):
            with within(vol):
                self._write_outputs(host, aff, out_dir, ext)
            vol.close()

        with ThreadPoolExecutor(max_workers=2) as ex:
            vol = annotate("serve.volume", unit=True).open()
            load = ex.submit(load_one, vol, input_paths[0])
            write = None
            try:
                for i, p in enumerate(input_paths):
                    im, aff, _, _ = load.result()
                    this = vol
                    if i + 1 < len(input_paths):
                        vol = annotate("serve.volume", unit=True).open()
                        load = ex.submit(load_one, vol, input_paths[i + 1])
                    out_dir = self._out_dir(save_dir, p)
                    if writes:
                        os.makedirs(out_dir, exist_ok=True)
                    with within(this):
                        if save_input and writes:
                            count("host_syncs")
                            viewVolume(im.cpu().numpy(), aff,
                                       names=["input"], ext=ext,
                                       save_dir=out_dir)
                        with annotate("serve.forward"):
                            outs = self.evaluate_image(im, keep_feat=False)
                        host = self.fetch_outputs(outs, exclude_keys)
                    del outs
                    if write is not None:
                        write.result()
                    if writes:
                        write = ex.submit(write_one, this, host, aff,
                                          out_dir)
                    else:
                        this.close()
                    results.append(out_dir)
            finally:
                # a pending write's failure surfaces even when a later
                # stage raised first
                if write is not None:
                    write.result()
        return results

    def _evaluate_path_batched(self, input_paths, save_dir, win_size,
                               exclude_keys, ext, save_input, batch_size,
                               prefetch=True):
        """Group-batched serving (see evaluate_path). With a mesh a bucket
        that is not a multiple of the 'data' axis is padded by repeating
        its last volume, the extra outputs dropped, and each data rank
        serves and writes its own volumes (space rank 0 writes); without
        one a partial bucket runs at its own batch size (nothing is
        compiled per shape)."""
        groups = [input_paths[i:i + batch_size]
                  for i in range(0, len(input_paths), batch_size)]
        n_data, r_data = self._data()
        space_writer = (self.mesh is None
                        or axis_index(self.mesh, "space") == 0)

        @torch.inference_mode()
        def compute_group(g, loaded):
            buckets: dict = {}
            for pos, (im, _, _, _) in enumerate(loaded):
                buckets.setdefault(tuple(im.shape), []).append((pos, im))
            out_host = [None] * len(g)
            for shp, members in buckets.items():
                n_real = len(members)
                pad_to = -(-n_real // n_data) * n_data
                if pad_to > n_real:
                    print(f"evaluate_path: padding {n_real} volume(s) of "
                          f"shape {shp} to a batch of {pad_to} "
                          f"({pad_to - n_real} redundant recompute(s))")
                vols = [im for _, im in members]
                vols += [vols[-1]] * (pad_to - n_real)
                x = torch.stack(vols)[..., None]
                host = self.fetch_outputs(
                    self._local_batch(self._as_input(x), True, False),
                    exclude_keys)
                m = pad_to // n_data
                for i in range(m):
                    j = r_data * m + i
                    if j < n_real:
                        out_host[members[j][0]] = {
                            k: v[i:i + 1] for k, v in host.items()}
            return out_host

        def write_group(host_list, g, affs):
            for p, aff, one in zip(g, affs, host_list):
                if one is None or not space_writer:
                    continue
                out_dir = self._out_dir(save_dir, p)
                os.makedirs(out_dir, exist_ok=True)
                self._write_outputs(one, aff, out_dir, ext)

        def save_inputs(g, loaded):
            if not self._writes():
                return
            for p, (im, aff, _, _) in zip(g, loaded):
                out_dir = self._out_dir(save_dir, p)
                os.makedirs(out_dir, exist_ok=True)
                viewVolume(im.cpu().numpy(), aff, names=["input"], ext=ext,
                           save_dir=out_dir)

        results = []
        # dec reads a group's members in parallel; wr carries the group
        # loader and the one group write in flight (a dec.map started from
        # a dec worker could deadlock when every dec worker is busy)
        with ThreadPoolExecutor(max_workers=batch_size) as dec, \
                ThreadPoolExecutor(max_workers=2) as wr:

            def load_group(g):
                return list(dec.map(lambda p: self._prepare(p, win_size), g))

            if not prefetch:
                for g in groups:
                    loaded = load_group(g)
                    if save_input:
                        save_inputs(g, loaded)
                    affs = [aff for _, aff, _, _ in loaded]
                    write_group(compute_group(g, loaded), g, affs)
                    results.extend(self._out_dir(save_dir, p) for p in g)
                return results

            load = wr.submit(load_group, groups[0])
            write = None
            try:
                for gi, g in enumerate(groups):
                    loaded = load.result()
                    if gi + 1 < len(groups):
                        load = wr.submit(load_group, groups[gi + 1])
                    if save_input:
                        save_inputs(g, loaded)
                    affs = [aff for _, aff, _, _ in loaded]
                    host_list = compute_group(g, loaded)
                    if write is not None:
                        write.result()
                    write = wr.submit(write_group, host_list, g, affs)
                    results.extend(self._out_dir(save_dir, p) for p in g)
            finally:
                if write is not None:
                    write.result()
        return results


class TwoStageInferencer(Inferencer):
    """Two-stage inpainting served as Inferencer serves one model: stage 0
    predicts the pathology mask, stage 1 the task outputs from the masked
    input conditioned on it, then the processors (stage 0's sigmoid kept)
    and `postprocess` (the label map through K2).

    pathol_ckpt / task_ckpt: a checkpoint directory of the two-stage
    training of the port or of the JAX package (an orbax TrainState whose
    params are {pathol, task}): the run's ckp/ root, whose newest step
    checkpoint is read, or one ckpt_* directory; each stage takes its own
    part, and a directory named for both stages is read once. Or each
    stage's `.pth` / `.pt` state dict; without one a stage's weights are
    random, from seed 0. `mesh`: as Inferencer's."""

    def __init__(self, cfg, pathol_ckpt=None, task_ckpt=None,
                 compute_dtype=torch.float32, exact: bool = True,
                 device=None, mesh=None):
        self._ckpts = {"pathol": pathol_ckpt, "task": task_ckpt}
        super().__init__(cfg, None, compute_dtype, exact, device, mesh)

    def _build(self, cfg):
        return build_inpaint_model(cfg, device=self.device)

    def _load(self, ckpt_path):
        del ckpt_path
        trees = {}   # one read of a checkpoint that both stages name
        for stage, path in self._ckpts.items():
            if not path:
                continue
            part = getattr(self.model, stage)
            path = str(path)
            if path.endswith((".pth", ".pt")):
                load_pth(part, path)
                continue
            path = resolve_checkpoint(path)
            if path not in trees:
                trees[path] = (orbax_read.restore(path, ("params",))
                               if is_orbax_dir(path) else
                               torch.load(os.path.join(path, MODEL_FILE),
                                          map_location=self.device,
                                          weights_only=True))
            if is_orbax_dir(path):
                # the pair's params are {pathol, task}; a single model's
                # tree serves as either stage, as in the JAX package
                tree = trees[path]
                sd = from_jax_params(tree.get(stage, tree))
            else:
                sd = {k[len(stage) + 1:]: v for k, v in trees[path].items()
                      if k.startswith(stage + ".")}
            part.load_state_dict(sd, strict=True)

    @torch.inference_mode()
    def evaluate_image(self, inputs, feature_only: bool = False,
                       run_postprocess: bool = True, keep_feat: bool = True):
        """As Inferencer.evaluate_image; feature_only returns the last
        feature level of each stage, (stage 0's, stage 1's)."""
        if not feature_only:
            return super().evaluate_image(inputs, False, run_postprocess,
                                          keep_feat)
        x = self._as_input(inputs)
        if x.dim() == 3:
            x = x[None, ..., None]
        out = self._forward(x)
        return out["feat_pathol"][-1], out["feat_task"][-1]


# The deformed-atlas source; the reference ships it as files/gca.mgz.
# Override order: explicit atlas_path argument > cfg key `atlas_path`
# (cfgs/trainer/default_val.yaml) > $BRAINFM_ATLAS_PATH > files/gca.mgz at
# the root of this repository.
DEFAULT_ATLAS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "files", "gca.mgz")


def default_atlas_path(cfg=None) -> str:
    """Resolve the atlas path from cfg/env (see DEFAULT_ATLAS_PATH)."""
    p = getattr(cfg, "atlas_path", None) if cfg is not None else None
    return p or os.environ.get("BRAINFM_ATLAS_PATH") or DEFAULT_ATLAS_PATH


@functools.lru_cache(maxsize=2)
def _load_atlas(path: str, device: str):
    """(atlas volume on `device`, inverse of its affine as fp32 numbers)."""
    mni, aff2 = MRIread(path)
    A = np.linalg.inv(aff2).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(mni)).to(device),
            [[float(v) for v in row] for row in A])


def get_deformed_atlas(brain_labels, regx, regy, regz,
                       atlas_path: str | None = None):
    """Warp the MNI atlas through predicted registration coordinates
    (parity: test_utils.py:45-57). The atlas source coordinates
    `inv(atlas affine) @ (100 * reg)` are computed in fp32 in the JAX
    package's order of operations; the warp is K1 (C=1, default 0) on CUDA.
    Tensors of one shape on one device; returns that shape."""
    atlas_path = atlas_path or default_atlas_path()
    mni, A = _load_atlas(atlas_path, str(regx.device))
    xx = 100.0 * regx
    yy = 100.0 * regy
    zz = 100.0 * regz
    ii = A[0][0] * xx + A[0][1] * yy + A[0][2] * zz + A[0][3]
    jj = A[1][0] * xx + A[1][1] * yy + A[1][2] * zz + A[1][3]
    kk = A[2][0] * xx + A[2][1] * yy + A[2][2] * zz + A[2][3]
    vals = warp_volume(mni, (ii, jj, kk), default=0.0)
    return torch.where(brain_labels > 0, vals, 0.0)
