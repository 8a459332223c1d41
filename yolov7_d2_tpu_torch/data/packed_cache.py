"""Packed shards of pre-augmented samples (offline mosaic) and their loaders
(a copy of ``yolov7_d2_tpu/data/packed_cache.py``).

The mosaic and perspective of ``YOLOXDatasetMapper`` run offline into
fixed-shape shards, so that the training-time loader is ``np.load`` +
index + stack; the photometric stage runs on the card
(``data/device_aug.py``). Shard format: ``<dir>/shard_NNNNN.npz`` with
image [N,H,W,3] uint8 (the mappers emit float 0..255; rounding to uint8
loses < 0.5 LSB of the 0.5/0.5 mixup blends), gt_boxes [N,M,4] f32,
gt_classes [N,M] i32, gt_valid [N,M] bool, plus any extra gt_ fields the
mapper emitted.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np


_CORE = ("gt_boxes", "gt_classes", "gt_valid")


def write_packed_shards(
    records: List[dict],
    mapper: Callable[[dict], Dict[str, np.ndarray]],
    out_dir: str,
    epochs: int = 1,
    shard_size: int = 512,
    seed: int = 0,
    fields: Optional[List[str]] = None,
) -> int:
    """Run ``mapper`` over ``records`` for ``epochs`` stochastic passes and
    write fixed-shape shards. Returns the number of samples written."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    buf: List[Dict[str, np.ndarray]] = []
    n_shard = 0
    n_total = 0

    def flush():
        nonlocal n_shard
        if not buf:
            return
        keys = fields or [
            k for k in buf[0]
            if k == "image" or k in _CORE or k.startswith("gt_")
        ]
        out = {}
        for k in keys:
            stacked = np.stack([s[k] for s in buf])
            if k == "image" or k == "gt_masks":
                stacked = np.clip(np.round(stacked), 0, 255).astype(np.uint8)
            out[k] = stacked
        np.savez(os.path.join(out_dir, f"shard_{n_shard:05d}.npz"), **out)
        n_shard += 1
        buf.clear()

    for _ in range(epochs):
        order = rng.permutation(len(records))
        for i in order:
            sample = mapper(records[int(i)])
            buf.append(sample)
            n_total += 1
            if len(buf) >= shard_size:
                flush()
    flush()
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"num_samples": n_total, "num_shards": n_shard}, f)
    return n_total


class PackedShardLoader:
    """Batched loader over packed shards: shard-level shuffle + in-shard
    permutation per epoch, zero augmentation work at train time. Yields
    dicts with image float32 (the mappers' output dtype) and the gt_*
    fields as stored."""

    def __init__(
        self,
        shard_dir: str,
        batch_size: int,
        shuffle: bool = True,
        infinite: bool = True,
        seed: int = 0,
        image_dtype=np.float32,
    ):
        self.paths = sorted(glob.glob(os.path.join(shard_dir, "shard_*.npz")))
        if not self.paths:
            raise FileNotFoundError(f"no shards under {shard_dir}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.infinite = infinite
        self.rng = np.random.default_rng(seed)
        self.image_dtype = image_dtype

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        carry: Optional[Dict[str, np.ndarray]] = None
        while True:
            order = (
                self.rng.permutation(len(self.paths))
                if self.shuffle
                else np.arange(len(self.paths))
            )
            for si in order:
                with np.load(self.paths[int(si)]) as z:
                    shard = {k: z[k] for k in z.files}
                n = len(shard["image"])
                idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
                start = 0
                if carry is not None:
                    need = self.batch_size - len(carry["image"])
                    take = idx[:need]
                    carry = {
                        k: np.concatenate([carry[k], shard[k][take]])
                        for k in shard
                    }
                    start = need
                    if len(carry["image"]) == self.batch_size:
                        yield self._cast(carry)
                        carry = None
                    else:
                        continue
                for b0 in range(start, n - self.batch_size + 1,
                                self.batch_size):
                    take = idx[b0 : b0 + self.batch_size]
                    yield self._cast({k: shard[k][take] for k in shard})
                rem = (n - start) % self.batch_size
                if rem:
                    take = idx[n - rem :]
                    carry = {k: shard[k][take] for k in shard}
            if not self.infinite:
                if carry is not None and len(carry["image"]):
                    yield self._cast(carry)
                return

    def _cast(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        out["image"] = np.ascontiguousarray(
            batch["image"], self.image_dtype
        )
        if "gt_masks" in out:
            out["gt_masks"] = out["gt_masks"].astype(np.float32)
        return out


def geometry_only_cfg(cfg):
    """Writer config for PACKED_CACHE_DIR shards: geometry only.

    The production split is geometry OFFLINE (mosaic/perspective baked
    into the shards) and photometrics ON DEVICE
    (``DevicePhotometric``: mixup blend + HSV + flip, re-randomized per
    step). Shards written with the full train mapper would bake the
    photometrics a first time and the device aug would re-apply them —
    double mixup (quarter-weight composites), double HSV, possible
    double flip. This clone disables every photometric the device path
    re-applies."""
    out = cfg.clone()
    out.defrost()
    out.INPUT.MOSAIC_AND_MIXUP.ENABLE_MIXUP = False
    out.INPUT.DISTORTION.ENABLED = False
    out.INPUT.RANDOM_FLIP_HORIZONTAL.ENABLED = False
    out.INPUT.RANDOM_FLIP_VERTICAL.ENABLED = False
    out.freeze()
    return out


def plain_cfg(cfg):
    """Writer config for PACKED_CACHE_PLAIN_DIR shards: NO augmentation.

    The reference's ``DISABLE_AT_ITER`` switches the train mapper to
    plain resized images for the final iterations
    (dataset_mapper.py:400,490) — the recipe's known-to-matter last
    phase. Mosaic-baked shards cannot reproduce that by turning off
    photometrics alone; the plain shard set replaces them at the switch
    iteration (``SwitchingPackedLoader``)."""
    out = cfg.clone()
    out.defrost()
    out.INPUT.MOSAIC_AND_MIXUP.ENABLED = False
    out.INPUT.MOSAIC_AND_MIXUP.ENABLE_MIXUP = False
    out.INPUT.DISTORTION.ENABLED = False
    out.INPUT.RANDOM_FLIP_HORIZONTAL.ENABLED = False
    out.INPUT.RANDOM_FLIP_VERTICAL.ENABLED = False
    out.freeze()
    return out


def write_geometry_shards(records, cfg, out_dir, **kw) -> int:
    """write_packed_shards with the geometry-only mapper (see
    ``geometry_only_cfg``) — the correct writer for
    DATALOADER.PACKED_CACHE_DIR."""
    from yolov7_d2_tpu_torch.data.mappers import YOLOXDatasetMapper

    mapper = YOLOXDatasetMapper(
        geometry_only_cfg(cfg), is_train=True, seed=kw.pop("mapper_seed", 0))
    return write_packed_shards(records, mapper, out_dir, **kw)


def write_plain_shards(records, cfg, out_dir, **kw) -> int:
    """write_packed_shards with the un-augmented mapper (see
    ``plain_cfg``) — the correct writer for
    DATALOADER.PACKED_CACHE_PLAIN_DIR (the post-DISABLE_AT_ITER feed)."""
    from yolov7_d2_tpu_torch.data.mappers import YOLOXDatasetMapper

    mapper = YOLOXDatasetMapper(
        plain_cfg(cfg), is_train=True, seed=kw.pop("mapper_seed", 0))
    return write_packed_shards(records, mapper, out_dir, epochs=1, **kw)


class SwitchingPackedLoader:
    """DISABLE_AT_ITER semantics over packed shards: yield from the
    augmented (mosaic-baked) shard set for ``switch_after`` batches, then
    from the plain shard set forever — mirroring the reference's
    dataset_mapper.py:400,490 mapper switch. The device photometric wrap
    (``make_packed_photo_step``) independently cuts mixup/HSV/flip at the
    same iteration via its ``lax.cond``, so post-switch batches are fully
    un-augmented, exactly like the reference's final phase."""

    def __init__(self, aug_loader, plain_loader, switch_after: int):
        self.aug_loader = aug_loader
        self.plain_loader = plain_loader
        self.switch_after = max(int(switch_after), 0)

    def __iter__(self):
        n = 0
        if self.switch_after > 0:
            for batch in self.aug_loader:
                yield batch
                n += 1
                if n >= self.switch_after:
                    break
        for batch in self.plain_loader:
            yield batch

