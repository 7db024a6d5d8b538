"""The cls confusion-matrix tools of the port (counterparts of the root
``tools/confusion_matrix/``): ``get_cls_confusion_matrix`` builds the
matrix from saved labels and scores, ``plot_confusion_matrix`` draws it
(where matplotlib is installed)."""
