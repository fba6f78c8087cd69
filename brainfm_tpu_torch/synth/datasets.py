"""Host-side dataset layer (port of brainfm_tpu/synth/datasets.py): the
dataset registry and its layout, split-file subject lists and the age
table, the stroke-lesion pool, one SynthDataset per dataset (a subject
bank read through the port's codec, the modality roulette, synth_item)
and the ConcatStream that mixes them for train().

Randomness: the subject plan and each dataset's modality and lesion
roulettes are numpy generators seeded as in the JAX package, so a plan is
the JAX stream's exactly. Each item's draws come from a torch.Generator on
the item's device seeded from (seed, epoch, item index), in place of the
JAX package's fold_in of a PRNG key.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import zlib
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..config import AttrDict
from ..device import resolve_device
from ..parallel.mesh import process_index
from .engine import SubjectBank, knobs_from_cfg, synth_item
from .params import SynthStatic
from .sampler import WeightedSubjectSampler, choose_modality

# Per-dataset layout. `root` is joined onto gen_cfg.data_root.
DATASET_SETUPS: Dict[str, dict] = {
    "ADHD": {
        "root": "adhd200_crop", "pathology_type": None,
        "modalities": ["T1"],
        "paths": {"Gen": "label_maps_generation", "T1": "T1",
                  "segmentation": "label_maps_segmentation"},
    },
    "HCP": {
        "root": "hcp_crop", "pathology_type": None,
        "modalities": ["T1", "T2"],
        "paths": {"Gen": "label_maps_generation", "T1": "T1", "T2": "T2",
                  "segmentation": "label_maps_segmentation"},
    },
    "AIBL": {
        "root": "aibl_crop", "pathology_type": None,
        "modalities": ["T1", "T2", "FLAIR"],
        "paths": {"Gen": "label_maps_generation", "T1": "T1", "T2": "T2",
                  "FLAIR": "FLAIR",
                  "segmentation": "label_maps_segmentation"},
    },
    "OASIS": {
        "root": "oasis3", "pathology_type": None,
        "modalities": ["T1", "CT"],
        "paths": {"Gen": "label_maps_generation", "T1": "T1", "CT": "CT",
                  "segmentation": "label_maps_segmentation"},
    },
    "ADNI": {
        "root": "adni", "pathology_type": None,
        "modalities": ["T1"],
        "paths": {"Gen": "label_maps_generation", "T1": "T1",
                  "segmentation": "label_maps_segmentation"},
    },
    "ADNI3": {
        "root": "adni3", "pathology_type": None,
        "modalities": ["T1", "FLAIR"],
        "paths": {"Gen": "label_maps_generation", "T1": "T1",
                  "FLAIR": "FLAIR",
                  "segmentation": "label_maps_segmentation"},
    },
    "ATLAS": {
        "root": "atlas", "pathology_type": "stroke",
        "modalities": ["T1"],
        "paths": {"Gen": "label_maps_generation", "T1": "T1",
                  "segmentation": "label_maps_segmentation",
                  "pathology": "pathology_maps",
                  "pathology_prob": "pathology_probs"},
    },
    "ISLES": {
        "root": "isles2022", "pathology_type": "stroke",
        "modalities": ["T1", "FLAIR"],
        "paths": {"Gen": "label_maps_generation", "T1": "T1",
                  "FLAIR": "FLAIR",
                  "segmentation": "label_maps_segmentation",
                  "pathology": "pathology_maps",
                  "pathology_prob": "pathology_probs"},
    },
}


def pathology_pool(data_root: str, setups=DATASET_SETUPS):
    """The stroke datasets' lesion maps and lesion-probability files."""
    paths, probs = [], []
    for name, d in setups.items():
        if d.get("pathology_type") == "stroke" and "pathology" in d["paths"]:
            base = os.path.join(data_root, d["root"])
            for ext in ("*.nii.gz", "*.nii"):
                paths += sorted(glob.glob(
                    os.path.join(base, d["paths"]["pathology"], ext)))
                probs += sorted(glob.glob(
                    os.path.join(base, d["paths"]["pathology_prob"], ext)))
    return paths, probs


def _read_split(split_root: str, split: str, dataset: str,
                age_task: bool = False):
    """One dataset's subject names from the shared split file
    (`<split>.txt`, or `<split>_age.txt` with the age task): the lines
    whose base name starts with the dataset's name."""
    if age_task:
        split = split + "_age"
    fn = os.path.join(split_root, split + ".txt")
    if not os.path.exists(fn):
        return []
    with open(fn) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    return [n for n in names if os.path.basename(n).startswith(dataset)]


def _read_ages(split_root: str):
    """`participants_age.txt`: one `<subject> <age>` per line."""
    fn = os.path.join(split_root, "participants_age.txt")
    ages = {}
    if os.path.exists(fn):
        with open(fn) as f:
            for ln in f:
                parts = ln.strip().split()
                if len(parts) == 2:
                    ages[parts[0]] = float(parts[1])
    return ages


def item_generator(seed: int, epoch: int, item: int, device):
    """The torch.Generator of one stream item, on `device`, seeded from
    (seed, epoch, item) only."""
    s = np.random.SeedSequence((seed + 1, epoch, item)).generate_state(
        1, np.uint64)
    return torch.Generator(device).manual_seed(int(s[0] >> np.uint64(1)))


class SynthDataset:
    """One dataset's training stream: its subject bank, modality roulette
    and lesion pool, and synth_item on the dataset's device."""

    def __init__(self, name: str, gen_cfg, tasks, static: SynthStatic,
                 bank_shape=(192, 192, 192), input_prob: Optional[dict] = None,
                 debug_subjects: int = 0, debug_extent=(160, 160, 160),
                 device=None):
        self.name = name
        self.setup = DATASET_SETUPS.get(name, DATASET_SETUPS["ADHD"])
        self.tasks = tuple(tasks)
        self.static = static
        self.bank = SubjectBank(bank_shape)
        self.input_prob = input_prob or {}
        self.device = resolve_device(device)
        self._gen_cfg = gen_cfg
        self._rng = np.random.default_rng(zlib.crc32(name.encode()))
        self._knobs = {}

        data_root = getattr(gen_cfg, "data_root", None)
        split_root = getattr(gen_cfg, "split_root", None)
        if data_root and split_root and os.path.isdir(data_root):
            self._load_real(data_root, split_root,
                            getattr(gen_cfg, "split", "train"))
        for i in range(debug_subjects):
            self.bank.add_debug_subject(seed=i, extent=debug_extent)

        # the stroke-lesion pool that healthy subjects' pathology draws
        # from: sampling spans every file of the pool, and an LRU of
        # `lesion_resident` (gen_cfg, default 16) decoded volumes bounds
        # the memory, warmed by one codec batch
        self._lesion_paths: list = []
        self._lesion_cache: OrderedDict = OrderedDict()
        self._lesion_resident = int(gen_cfg.get("lesion_resident") or 16) \
            if hasattr(gen_cfg, "get") else 16
        if "pathology" in self.tasks and data_root \
                and os.path.isdir(data_root):
            _, prob_paths = pathology_pool(data_root)
            self._lesion_paths = list(prob_paths)
            if prob_paths:
                from ..runtime.loader import VolCodec

                k = min(self._lesion_resident, len(prob_paths))
                print(f"[{name}] lesion pool: {len(prob_paths)} files, "
                      f"{k} resident (LRU, lesion_resident="
                      f"{self._lesion_resident}); sampling spans the full "
                      "pool")
                arena, _, extras = VolCodec(
                    self.bank.bank_shape).decode_batch_with_shapes(
                        prob_paths[:k])
                for i in range(k):
                    vol = extras.get(i)
                    self._lesion_cache[i] = (
                        SubjectBank._pad(np.asarray(vol, np.float32),
                                         self.bank.bank_shape)
                        if vol is not None else arena[i].copy())

    def _load_real(self, data_root, split_root, split):
        base = os.path.join(data_root, self.setup["root"])
        names = _read_split(split_root, split, self.name,
                            age_task="age" in self.tasks)
        ages = _read_ages(split_root) if "age" in self.tasks else {}
        p = self.setup["paths"]
        subj_paths, subj_ages = [], []
        for n in names:
            sid = os.path.basename(n).split(".")[0]
            paths = {}
            cands = glob.glob(os.path.join(base, p["Gen"], sid + "*"))
            if not cands:
                continue
            paths["gen"] = cands[0]
            for key, sub in (("seg", p.get("segmentation")),
                             ("T1", p.get("T1")), ("T2", p.get("T2")),
                             ("FLAIR", p.get("FLAIR")), ("CT", p.get("CT"))):
                if sub:
                    c = glob.glob(os.path.join(base, sub, sid + "*"))
                    if c:
                        paths[key] = c[0]
            subj_paths.append(paths)
            subj_ages.append(ages.get(sid))
        if subj_paths:
            # one codec batch for the whole split
            self.bank.add_many(subj_paths, ages=subj_ages)

    def __len__(self):
        return len(self.bank)

    def sample_weight(self, idx: int) -> float:
        """Per-subject sampling weight: uniform unless `subject_weights`
        is set."""
        w = getattr(self, "subject_weights", None)
        return float(w[idx]) if w is not None else 1.0

    def weights_array(self):
        w = getattr(self, "subject_weights", None)
        return None if w is None else np.asarray(w, np.float64)

    def reseed(self, seed: int):
        """Re-seed the modality and lesion roulette from `seed` (crc32 of
        the name, not hash(): str hashes are salted per process)."""
        self._rng = np.random.default_rng(
            (zlib.crc32(self.name.encode()), seed))

    def _draw_lesion(self, keys):
        """The roulette's draw of a lesion from the pool for a subject with
        `keys`, or None (no pool, or the subject has its own)."""
        if self._lesion_paths and "pathol_prob" not in keys:
            return int(self._rng.integers(len(self._lesion_paths)))
        return None

    def _with_lesion(self, subject, mode, lesion):
        """Alias the drawn real modality into 'image' and give the subject
        lesion map `lesion` of the pool (None: none)."""
        subject = dict(subject)
        if mode != "synth":
            subject["image"] = subject[mode]
        if lesion is not None:
            subject["pathol_prob"] = torch.from_numpy(
                self._lesion(lesion)).to(self.device)
        return subject

    def _prep_subject(self, subject, mode):
        """Alias the drawn real modality into 'image' and give the subject
        a lesion map from the dataset's pool: one roulette draw."""
        return self._with_lesion(subject, mode, self._draw_lesion(subject))

    def _lesion(self, i: int) -> np.ndarray:
        """Decoded lesion volume i, LRU-cached up to `lesion_resident`
        entries; files beyond the warm set are read by the codec on
        demand."""
        if i in self._lesion_cache:
            self._lesion_cache.move_to_end(i)
            return self._lesion_cache[i]
        from ..runtime.loader import VolCodec

        arena, _, extras = VolCodec(
            self.bank.bank_shape).decode_batch_with_shapes(
                [self._lesion_paths[i]])
        arr = (SubjectBank._pad(np.asarray(extras[0], np.float32),
                                self.bank.bank_shape)
               if 0 in extras else arena[0])
        while len(self._lesion_cache) >= max(1, self._lesion_resident):
            self._lesion_cache.popitem(last=False)
        self._lesion_cache[i] = arr
        return arr

    def _knobs_for(self, mode):
        if mode not in self._knobs:
            self._knobs[mode] = knobs_from_cfg(self._gen_cfg, self.static,
                                               mode)
        return self._knobs[mode]

    def get(self, idx: int, generator=None, draws=None, record=None,
            stats=None):
        """One training item of subject idx: (target, samples[S, ...]).
        generator/draws/record/stats: as synth_item's."""
        subject = self.bank.to_device(idx, self.device)
        mode = choose_modality(self._rng, self.input_prob, set(subject))
        subject = self._prep_subject(subject, mode)
        return synth_item(generator, subject, self.static, self.tasks, mode,
                          self._knobs_for(mode), draws=draws, record=record,
                          stats=stats)

    def get_group(self, idxs, load=None):
        """The subjects and modality of a grouped batch, as the JAX
        package's get_group draws them: each item's modality against its
        own subject's volumes, all the modalities first. When every draw
        lands on one mode the subjects are cut to the keys they share,
        then each takes its lesion draw in item order, and (subjects,
        mode) is returned; otherwise (None, modes), and the caller draws
        per item (get_batch_sharded). `load`: the item positions whose
        subjects are put on the device (default all; the other entries
        are None, their roulette draws still taken)."""
        modes = [choose_modality(self._rng, self.input_prob,
                                 set(self.bank.subjects[i])) for i in idxs]
        if len(set(modes)) > 1:
            return None, modes
        mode = modes[0]
        common = set(self.bank.subjects[idxs[0]])
        for i in idxs[1:]:
            common &= set(self.bank.subjects[i])
        load = range(len(idxs)) if load is None else set(load)
        out = []
        for pos, i in enumerate(idxs):
            lesion = self._draw_lesion(common)
            if pos in load:
                s = self.bank.to_device(i, self.device)
                out.append(self._with_lesion({k: s[k] for k in common},
                                             mode, lesion))
            else:
                out.append(None)
        return out, mode

    def get_batch_sharded(self, mesh, idxs, generators, axes=("data",)):
        """This rank's rows of one train batch over the mesh: item i of
        `idxs` drawn from `generators[i]` on its own data rank
        (synth/sharded.py). Every rank takes every roulette draw, so the
        ranks agree on the batch. A batch whose modality draws disagree
        is made per item, each item's lesion drawn in turn, as the JAX
        package's fallback."""
        from .sharded import local_items, sharded_synth_batch

        mine = local_items(mesh, len(idxs), axes)
        subjects, mode = self.get_group(idxs, load=mine)
        if subjects is None:
            subjects = []
            for pos, (i, m) in enumerate(zip(idxs, mode)):
                lesion = self._draw_lesion(self.bank.subjects[i])
                subjects.append(self._with_lesion(
                    self.bank.to_device(i, self.device), m, lesion)
                    if pos in mine else None)
        knobs = ([self._knobs_for(m) for m in mode] if isinstance(mode, list)
                 else self._knobs_for(mode))
        return sharded_synth_batch(mesh, generators, subjects, self.static,
                                   self.tasks, mode, knobs, axes=axes,
                                   per_item_subject=True)


class ConcatStream:
    """Probability-weighted mixing of the datasets, one subject plan per
    epoch."""

    def __init__(self, datasets: Dict[str, SynthDataset], probs=None,
                 seed: int = 0):
        self.names = list(datasets)
        self.datasets = datasets
        self.seed = seed
        sizes = [len(datasets[n]) for n in self.names]
        self.sampler = WeightedSubjectSampler(
            sizes, probs, seed=seed, process_index=process_index(),
            subject_weights=[datasets[n].weights_array() for n in self.names])
        empty = [n for n, size, p in zip(self.names, sizes,
                                         self.sampler.probs)
                 if size == 0 and p > 0]
        if empty:
            raise ValueError(
                f"datasets {empty} hold no subjects (none of their split "
                "file's subjects found under the data root) but may be "
                "drawn; list the datasets present in dataset_names")

    def _start_epoch(self, epoch_idx: int):
        self.sampler.set_epoch(epoch_idx)
        for n in self.names:
            self.datasets[n].reseed(self.seed + epoch_idx)

    def epoch(self, epoch_idx: int, count: int, seed: int = 0):
        """Yield (dataset_name, target, samples) for `count` items,
        reproducible from (seed, epoch_idx): the subject plan is
        epoch-seeded, each dataset's roulette is re-seeded at epoch start,
        and item i draws from item_generator(seed, epoch_idx, i)."""
        self._start_epoch(epoch_idx)
        for i, (d, s) in enumerate(self.sampler.sample(count)):
            name = self.names[d]
            ds = self.datasets[name]
            gen = item_generator(seed, epoch_idx, i, ds.device)
            target, samples = ds.get(s, gen)
            yield name, target, samples

    def epoch_grouped(self, epoch_idx: int, n_batches: int,
                      batch_items: int):
        """Batch-grouped plan: (dataset_name, subject_idxs), one dataset
        per batch; reproducible from (seed, epoch_idx) like `epoch`."""
        self._start_epoch(epoch_idx)
        for d, idxs in self.sampler.sample_grouped(n_batches, batch_items):
            yield self.names[d], idxs


def build_datasets(gen_cfg, tasks, device=None, bank_shape=(192, 192, 192),
                   debug_extent=(160, 160, 160)) -> Dict[str, SynthDataset]:
    """One SynthDataset per configured dataset name, plus their
    ConcatStream under '_concat'.

    `gen_cfg` follows cfgs/generator/default.yaml (size, sample counts and
    knobs under `generator:`; dataset_names, data_root, modality_probs at
    the top); a flat cfg with a top-level `size` is taken as the generator
    block itself. Empty dataset_names means every dataset. Without a data
    root on disk each dataset holds one procedural debug subject of
    `debug_extent`. `device`: where the items are made (default CUDA)."""
    g = gen_cfg.get("generator") if hasattr(gen_cfg, "get") else None
    if g is None or isinstance(g, str) or not hasattr(g, "get"):
        flat = dict(gen_cfg)
        flat.pop("generator", None)
        cfg_tree = AttrDict(dict(gen_cfg))
        cfg_tree["generator"] = AttrDict(flat)
    else:
        cfg_tree = gen_cfg

    dataset_option = gen_cfg.get("dataset_option")
    if dataset_option is None and isinstance(gen_cfg.get("generator"), str):
        dataset_option = gen_cfg.get("generator")
    static = SynthStatic.from_cfg(cfg_tree)
    if (dataset_option or "brain_id") == "default":
        # one sample per item; it keeps the severe knob row unless mild
        # samples were configured
        static = dataclasses.replace(
            static, all_samples=1, mild_samples=min(static.mild_samples, 1))

    names = list(gen_cfg.get("dataset_names") or list(DATASET_SETUPS))
    probs = gen_cfg.get("dataset_probs")
    input_prob = gen_cfg.get("modality_probs") or gen_cfg.get("input_prob")
    debug = 0 if (gen_cfg.get("data_root")
                  and os.path.isdir(str(gen_cfg.get("data_root")))) else 1

    # the modality table keys two datasets by their release names
    aliases = {"ADHD": "ADHD200", "OASIS": "OASIS3"}
    out = {}
    for n in names:
        ip = None
        if hasattr(input_prob, "get"):
            ip = input_prob.get(n) or input_prob.get(aliases.get(n, n))
        ip = dict(ip) if hasattr(ip, "keys") else {}
        out[n] = SynthDataset(n, gen_cfg, tasks, static, bank_shape,
                              input_prob=ip, debug_subjects=debug,
                              debug_extent=debug_extent, device=device)
    out["_concat"] = ConcatStream(out, probs)
    return out
