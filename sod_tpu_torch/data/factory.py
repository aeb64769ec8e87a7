"""Dataset factory of the port (twin of ``sod_tpu/data/factory.py``
``get_dataset``) for the benchmarks it evaluates and the DUTS train split.

Errors: the names the reference factory mentions without a class
(cub2011, flowers102, hku_is, sod, imagenet1k) raise ``NotImplementedError``
with ``sod_tpu``'s message and any other unknown name ``ValueError``, as in
``sod_tpu``.  Two differ from ``sod_tpu`` on purpose: a split a dataset does
not have raises ``ValueError`` (an ``assert`` there), and a benchmark
directory whose images and masks do not pair up raises ``FileNotFoundError``
from the dataset class (an ``assert`` there); the Trainer catches the latter,
and the Evaluator's own for an empty or missing directory, to log a skipped
benchmark."""
from __future__ import annotations

import os
from typing import Optional, Tuple


def get_dataset(dir_dataset: str, dataset_name: str, mode: str,
                train_img_size: Optional[int] = None,
                eval_img_size: Optional[int] = None,
                scale_range: Tuple[float, float] = (0.8, 1.2),
                use_pseudo_masks: bool = False,
                pseudo_masks_fp: Optional[str] = None,
                use_copy_paste: bool = False, **_ignored):
    from sod_tpu_torch.data.dut_omron import DUTOMRONDataset
    from sod_tpu_torch.data.duts import DUTSDataset
    from sod_tpu_torch.data.ecssd import ECSSDDataset

    if dataset_name == "duts":
        if mode not in ("train", "test"):
            raise ValueError(f"duts has no {mode!r} split")
        ds = DUTSDataset(dir_dataset=f"{dir_dataset}/DUTS",
                         img_size=train_img_size or 224, scale_range=scale_range,
                         use_pseudo_masks=use_pseudo_masks,
                         pseudo_masks_fp=pseudo_masks_fp,
                         use_copy_paste=use_copy_paste)
    elif dataset_name in ("ecssd", "dut_omron"):
        if mode != "test":
            raise ValueError(f"{dataset_name} dataset is only for test.")
        if dataset_name == "ecssd":
            ds = ECSSDDataset(f"{dir_dataset}/ECSSD", img_size=eval_img_size or 128)
        else:
            # the reference's factory points at "DUTS-OMRON" (sic); the
            # official "DUT-OMRON" layout is the fallback
            quirk = f"{dir_dataset}/DUTS-OMRON"
            official = f"{dir_dataset}/DUT-OMRON"
            root = (quirk if os.path.isdir(quirk) or not os.path.isdir(official)
                    else official)
            ds = DUTOMRONDataset(root, img_size=eval_img_size or 128)
    elif dataset_name in ("cub2011", "flowers102", "hku_is", "sod", "imagenet1k"):
        raise NotImplementedError(
            f"{dataset_name}: named by the reference factory "
            "(utils/misc.py:58-145) but its dataset class is absent from the "
            "reference repo")
    else:
        raise ValueError(f"Invalid dataset_name {dataset_name}.")
    ds.set_mode(mode)
    return ds
