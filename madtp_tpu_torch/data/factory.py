"""Dataset and loader factory (counterpart of
``madtp_tpu/data/factory.py:25-92``): ``create_dataset(name, config)`` gives
the reference's split tuples, ``create_loader`` a loader factory per split
(call it with ``epoch=``)."""

from __future__ import annotations

import random
from functools import partial
from typing import Sequence

from madtp_tpu_torch.data.datasets import (
    CaptionEvalDataset,
    CaptionTrainDataset,
    NLVRDataset,
    NoCapsEvalDataset,
    RetrievalEvalDataset,
    VQADataset,
)
from madtp_tpu_torch.data.loader import batched_loader
from madtp_tpu_torch.data.transforms import eval_transform, train_transform


def create_dataset(name: str, config: dict, *, min_scale: float = 0.5, seed: int = 42):
    """The reference's split tuples (reference ``data/__init__.py:18-73``)."""
    size = config["image_size"]
    rng = random.Random(seed)

    def tf_train(im):
        return train_transform(im, size, rng, min_scale=min_scale)

    def tf_test(im):
        return eval_transform(im, size)

    image_root, ann_root = config.get("image_root"), config["ann_root"]
    if name == "nlvr":
        return (NLVRDataset(tf_train, image_root, ann_root, "train"),
                NLVRDataset(tf_test, image_root, ann_root, "val"),
                NLVRDataset(tf_test, image_root, ann_root, "test"))
    if name == "caption_coco":
        return (CaptionTrainDataset(tf_train, image_root, ann_root,
                                    prompt=config.get("prompt", "")),
                CaptionEvalDataset(tf_test, image_root, ann_root, "val"),
                CaptionEvalDataset(tf_test, image_root, ann_root, "test"))
    if name == "nocaps":
        return (NoCapsEvalDataset(tf_test, image_root, ann_root, "val"),
                NoCapsEvalDataset(tf_test, image_root, ann_root, "test"))
    if name in ("retrieval_coco", "retrieval_flickr"):
        ds = "coco" if name.endswith("coco") else "flickr"
        return (CaptionTrainDataset(tf_train, image_root, ann_root, dataset=ds),
                RetrievalEvalDataset(tf_test, image_root, ann_root, "val", dataset=ds),
                RetrievalEvalDataset(tf_test, image_root, ann_root, "test", dataset=ds))
    if name == "vqa":
        return (VQADataset(tf_train, ann_root, config["vqa_root"], config.get("vg_root", ""),
                           split="train"),
                VQADataset(tf_test, ann_root, config["vqa_root"], config.get("vg_root", ""),
                           split="test"))
    raise ValueError(f"unknown dataset {name}")


def create_loader(datasets: Sequence, *, batch_size: Sequence[int], is_trains: Sequence[bool],
                  collate_fns: Sequence = None, num_shards: int = 1, shard_id: int = 0,
                  num_workers: int = 8, seed: int = 42):
    """A loader factory per split (reference ``data/__init__.py:83-104``)."""
    collate_fns = collate_fns or [None] * len(datasets)
    loaders = []
    for ds, bs, train, collate in zip(datasets, batch_size, is_trains, collate_fns):
        kw = dict(batch_size=bs, shuffle=train, drop_last=train, num_shards=num_shards,
                  shard_id=shard_id, num_workers=num_workers, seed=seed)
        if collate is not None:
            kw["collate"] = collate
        loaders.append(partial(batched_loader, ds, **kw))
    return loaders
