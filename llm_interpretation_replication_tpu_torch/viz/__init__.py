"""LaTeX tables (``viz.latex``) and figures (``viz.figures``, matplotlib's
Agg backend).  Nothing is imported here: importing ``viz.latex`` must not
load matplotlib, which the card's machine does not have."""
