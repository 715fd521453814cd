"""The paper's evaluation (Figs. 4 and 11-15) on the port: the harness
``common`` runs BFS, SSSP and PageRank over the Table-3-like datasets in
baseline and IRU mode, records their irregular-access traces and replays
them through the cost model; each ``fig*`` module prints one figure's rows.

Run a figure with ``python -m repro_torch.figures.fig14_coalescing``
(``--quick`` for CI-sized graphs, ``--engine hash_ref --device cpu`` to run
without a card).
"""
