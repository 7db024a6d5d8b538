"""Backbone feature-map visualisation tools of the port (counterparts of
the root ``tools/featmap_vis/``): ``_common`` builds the bare backbone on
``--device`` and renders top-k channel montages over an image folder
(``cls_vis_featmap``, ``dior_vis_featmap``), one image
(``vis_featmap_single_img``, ``cls_vis_featmap_single_img``,
``seg_vis_featmap_single_img``) or the config's test split
(``vis_featmap_test``, ``cls_vis_featmap_test``); ``draw_featmap`` is the
renderer and ``vis_featmap`` the per-level heatmap tool. Each tool is a
``main(argv)``; importing a module runs nothing."""
