"""Potsdam (seg, 512x512) featmap visualization for one image (the port's
counterpart of the root ``tools/featmap_vis/seg_vis_featmap_single_img.py``;
``--device`` picks the card or the CPU)::

    python -m rscotr_tpu_torch.tools.featmap_vis.seg_vis_featmap_single_img --help
"""

from rscotr_tpu_torch.tools.featmap_vis._common import single_img_main


def main(argv=None):
    return single_img_main("seg", argv)


if __name__ == "__main__":
    main()
