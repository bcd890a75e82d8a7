"""Data of the port: PNG files (``png.py``), the clip datasets and their
augmentations, the streaming frame source and palettes.

``get_loader`` is the reference's loader registry
(Training/ptsemseg/loader/__init__.py; ``tdnet_tpu/data/__init__.py``).
"""


def get_loader(name: str):
    from tdnet_tpu_torch.data.camvid import CamVidClips
    from tdnet_tpu_torch.data.cityscapes import CityscapesClips
    from tdnet_tpu_torch.data.nyudv2 import NYUDv2Clips
    return {
        "cityscapes": CityscapesClips,
        "camvid": CamVidClips,
        "nyud2": NYUDv2Clips,
        "nyudv2": NYUDv2Clips,
    }[name]
