"""Backbone featmap visualization for one image (generic sizes) (the port's
counterpart of the root ``tools/featmap_vis/vis_featmap_single_img.py``;
``--device`` picks the card or the CPU)::

    python -m rscotr_tpu_torch.tools.featmap_vis.vis_featmap_single_img --help
"""

from rscotr_tpu_torch.tools.featmap_vis._common import single_img_main


def main(argv=None):
    return single_img_main("cls", argv)


if __name__ == "__main__":
    main()
