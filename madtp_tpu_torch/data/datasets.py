"""Task datasets driven by annotation JSON (counterpart of
``madtp_tpu/data/datasets.py:37-242``).  Each dataset is an indexable object
whose items hold the transformed images as numpy arrays and Python scalars;
batching lives in :mod:`madtp_tpu_torch.data.loader`.  Images are read by
:func:`madtp_tpu_torch.data.image.open_image` as uint8 HWC RGB arrays, which
the transforms of :mod:`madtp_tpu_torch.data.transforms` take."""

from __future__ import annotations

import json
import os
import random
from typing import Callable, List

import numpy as np

from madtp_tpu_torch.data.image import open_image
from madtp_tpu_torch.data.text_utils import pre_caption, pre_question

ANN_FILES = {
    "nlvr": {"train": "nlvr_train.json", "val": "nlvr_dev.json",
             "test": "nlvr_test.json"},
    "coco": {"train": "coco_karpathy_train.json", "val": "coco_karpathy_val.json",
             "test": "coco_karpathy_test.json"},
    "flickr": {"train": "flickr30k_train.json", "val": "flickr30k_val.json",
               "test": "flickr30k_test.json"},
    "vqa": {"train": "vqa_train.json", "val": "vqa_val.json",
            "test": "vqa_test.json", "vg": "vg_qa.json",
            "answer_list": "answer_list.json"},
    "nocaps": {"val": "nocaps_val.json", "test": "nocaps_test.json"},
}


def _load_ann(ann_root: str, name: str):
    path = os.path.join(ann_root, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"annotation file {path} not found; download the annotation bundle into "
            f"{ann_root} (nothing is fetched automatically)")
    with open(path) as f:
        return json.load(f)


class NLVRDataset:
    """Two images, a sentence and a 0/1 label; training swaps the images at
    random and then swaps the words left and right (reference
    ``data/nlvr_dataset.py:77-98``)."""

    def __init__(self, transform: Callable, image_root: str, ann_root: str,
                 split: str, seed: int = 0):
        self.annotation = _load_ann(ann_root, ANN_FILES["nlvr"][split])
        self.transform = transform
        self.image_root = image_root
        self.train = split == "train"
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        image0 = self.transform(open_image(os.path.join(self.image_root, ann["images"][0])))
        image1 = self.transform(open_image(os.path.join(self.image_root, ann["images"][1])))
        sentence = pre_caption(ann["sentence"], 40)
        label = 1 if ann["label"] == "True" else 0

        if self.train:
            words = sentence.split(" ")
            if self.rng.random() >= 0.5:
                image0, image1 = image1, image0
                if "left" in words or "right" in words:
                    sentence = " ".join(
                        "right" if w == "left" else "left" if w == "right" else w
                        for w in words)
        return image0, image1, sentence, label


class CaptionTrainDataset:
    """COCO-Karpathy / Flickr30k caption training pairs."""

    def __init__(self, transform, image_root, ann_root, *, dataset="coco",
                 prompt: str = "", max_words: int = 30):
        self.annotation = _load_ann(ann_root, ANN_FILES[dataset]["train"])
        self.transform = transform
        self.image_root = image_root
        self.prompt = prompt
        self.max_words = max_words
        self.img_ids = {}
        for ann in self.annotation:
            self.img_ids.setdefault(ann["image_id"], len(self.img_ids))

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        image = self.transform(open_image(os.path.join(self.image_root, ann["image"])))
        caption = self.prompt + pre_caption(ann["caption"], self.max_words)
        return image, caption, self.img_ids[ann["image_id"]]


class CaptionEvalDataset:
    """Caption eval: the image and the COCO image id parsed from the file name
    (reference ``data/coco_karpathy_dataset.py:104``)."""

    def __init__(self, transform, image_root, ann_root, split, *, dataset="coco"):
        self.annotation = _load_ann(ann_root, ANN_FILES[dataset][split])
        self.transform = transform
        self.image_root = image_root

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        image = self.transform(open_image(os.path.join(self.image_root, ann["image"])))
        img_id = ann["image"].split("/")[-1].strip(".jpg").split("_")[-1]
        return image, int(img_id)


class RetrievalEvalDataset:
    """The images, the texts and the txt2img / img2txt maps
    (reference ``data/coco_karpathy_dataset.py:131-145``)."""

    def __init__(self, transform, image_root, ann_root, split, *,
                 dataset="coco", max_words: int = 30):
        self.annotation = _load_ann(ann_root, ANN_FILES[dataset][split])
        self.transform = transform
        self.image_root = image_root
        self.text: List[str] = []
        self.image: List[str] = []
        self.txt2img = {}
        self.img2txt = {}
        for img_id, ann in enumerate(self.annotation):
            self.image.append(ann["image"])
            self.img2txt[img_id] = []
            for caption in ann["caption"]:
                self.img2txt[img_id].append(len(self.text))
                self.txt2img[len(self.text)] = img_id
                self.text.append(pre_caption(caption, max_words))

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        image = self.transform(open_image(
            os.path.join(self.image_root, self.annotation[index]["image"])))
        return image, index


class VQADataset:
    """VQAv2 (and Visual Genome) with soft answer weights
    (reference ``data/vqa_dataset.py:81-107``)."""

    def __init__(self, transform, ann_root, vqa_root, vg_root="", split="train",
                 train_files=("vqa_train", "vqa_val", "vg_qa")):
        self.split = split
        self.transform = transform
        self.vqa_root = vqa_root
        self.vg_root = vg_root
        if split == "train":
            self.annotation = []
            for f in train_files:
                self.annotation += _load_ann(ann_root, f + ".json")
        else:
            self.annotation = _load_ann(ann_root, ANN_FILES["vqa"]["test"])
            self.answer_list = _load_ann(ann_root, ANN_FILES["vqa"]["answer_list"])

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        root = self.vg_root if ann.get("dataset") == "vg" else self.vqa_root
        image = self.transform(open_image(os.path.join(root, ann["image"])))
        if self.split == "test":
            return image, pre_question(ann["question"]), ann["question_id"]
        question = pre_question(ann["question"])
        if ann.get("dataset", "vqa") == "vqa":
            answer_weight = {}
            for answer in ann["answer"]:
                answer_weight[answer] = answer_weight.get(answer, 0) + 1 / len(ann["answer"])
            answers = list(answer_weight.keys())
            weights = list(answer_weight.values())
        else:  # Visual Genome: one answer, weight 0.2
            answers = [ann["answer"]]
            weights = [0.2]
        return image, question, answers, weights


def vqa_collate(batch):
    """Images stacked, the ragged answers flattened with a count per question
    (reference ``data/vqa_dataset.py:99-107``)."""
    images, questions, answers, weights, n = [], [], [], [], []
    for image, question, ans, w in batch:
        images.append(image)
        questions.append(question)
        answers += ans
        weights += w
        n.append(len(ans))
    return np.stack(images), questions, answers, np.asarray(weights, np.float32), n


class NoCapsEvalDataset:
    """NoCaps eval (reference ``data/nocaps_dataset.py``)."""

    def __init__(self, transform, image_root, ann_root, split):
        self.annotation = _load_ann(ann_root, ANN_FILES["nocaps"][split])
        self.transform = transform
        self.image_root = image_root

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        image = self.transform(open_image(os.path.join(self.image_root, ann["image"])))
        return image, int(ann["img_id"])
