"""RESISC45 (cls) backbone featmap visualization over an image folder (the
port's counterpart of the root ``tools/featmap_vis/cls_vis_featmap.py``;
``--device`` picks the card or the CPU)::

    python -m rscotr_tpu_torch.tools.featmap_vis.cls_vis_featmap --help
"""

from rscotr_tpu_torch.tools.featmap_vis._common import folder_main


def main(argv=None):
    return folder_main("cls", argv)


if __name__ == "__main__":
    main()
