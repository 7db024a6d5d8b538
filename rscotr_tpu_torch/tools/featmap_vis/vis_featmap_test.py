"""Backbone featmap visualization over the config's test split (the port's
counterpart of the root ``tools/featmap_vis/vis_featmap_test.py``; ``--device``
picks the card or the CPU)::

    python -m rscotr_tpu_torch.tools.featmap_vis.vis_featmap_test --help
"""

from rscotr_tpu_torch.tools.featmap_vis._common import test_split_main


def main(argv=None):
    return test_split_main("cls", argv)


if __name__ == "__main__":
    main()
