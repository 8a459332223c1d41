"""COCO-format dataset loading, pure JSON (a copy of
``yolov7_d2_tpu/data/coco.py``). Produces the dataset dict schema:
``{file_name, height, width, image_id, annotations: [{bbox (XYWH corner),
bbox_mode, category_id, segmentation, keypoints, iscrowd, area}]}``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

from yolov7_d2_tpu_torch.structures.boxes import BoxMode


# COCO's 80 thing classes have non-contiguous ids; remap to [0, 79].
COCO_CATEGORY_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]


def load_coco_json(
    json_file: str,
    image_root: str,
    dataset_name: Optional[str] = None,
    filter_empty: bool = False,
) -> List[dict]:
    with open(json_file, "r") as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    cat_ids = [c["id"] for c in cats]
    id_map: Dict[int, int] = {cid: i for i, cid in enumerate(cat_ids)}
    class_names = [c.get("name", str(c["id"])) for c in cats]

    if dataset_name is not None:
        from yolov7_d2_tpu_torch.data.catalog import MetadataCatalog

        MetadataCatalog.get(dataset_name).set(
            thing_classes=class_names,
            thing_dataset_id_to_contiguous_id=id_map,
        )

    anns_by_image = defaultdict(list)
    for ann in coco.get("annotations", []):
        anns_by_image[ann["image_id"]].append(ann)

    out: List[dict] = []
    for img in coco.get("images", []):
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
        }
        annotations = []
        for ann in anns_by_image.get(img["id"], []):
            if ann.get("ignore", 0):
                continue
            obj = {
                "bbox": ann["bbox"],  # COCO corner xywh
                "bbox_mode": int(BoxMode.XYWH_CORNER_ABS),
                "category_id": id_map.get(ann["category_id"], -1),
                "iscrowd": ann.get("iscrowd", 0),
                "area": ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
            }
            if obj["category_id"] < 0:
                continue
            if "segmentation" in ann:
                obj["segmentation"] = ann["segmentation"]
            if "keypoints" in ann:
                obj["keypoints"] = ann["keypoints"]
            annotations.append(obj)
        if filter_empty and not annotations:
            continue
        record["annotations"] = annotations
        out.append(record)
    return out

