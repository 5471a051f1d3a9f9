"""One driver per program entry a cell's window drives, named as the entry
in the cell's file (``workloads/<cell>.json``'s ``entry``): a ``Driver``
class and the ``expected`` and ``compare`` functions of its check."""
