"""Visual scripts of the port: the network table (``draw_net``), the GT
heatmap overlays (``heatmap_vis``) and the limb line integral
(``line_integral``)."""
