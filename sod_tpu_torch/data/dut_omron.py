"""DUT-OMRON test dataset of the port (twin of
``sod_tpu/data/dut_omron.py``): ``DUT-OMRON-image/*.jpg`` +
``pixelwiseGT-new-PNG/*.png``, test-only."""
from __future__ import annotations

from glob import glob
from os.path import join

from sod_tpu_torch.data.base import BaseDataset


class DUTOMRONDataset(BaseDataset):
    def __init__(self, dir_dataset: str, img_size: int = 128):
        super().__init__()
        self.p_test_imgs = sorted(glob(join(dir_dataset, "DUT-OMRON-image",
                                            "*.jpg")))
        self.p_test_gts = sorted(glob(join(dir_dataset, "pixelwiseGT-new-PNG",
                                           "*.png")))
        if len(self.p_test_imgs) != len(self.p_test_gts):
            raise FileNotFoundError(
                f"{dir_dataset}: {len(self.p_test_imgs)} images but "
                f"{len(self.p_test_gts)} masks")
        self.img_size = (img_size, img_size)
        self.name = "dut-omron"
