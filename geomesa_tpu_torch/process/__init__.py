"""Analytic processes over the datastore (port of ``geomesa_tpu/process``).

This slice ports the k-nearest-neighbour search (``knn_search``, whose
device top-k runs the ``knn_topk`` kernel) and TubeSelect
(``tube_select``). Proximity, route, tracks, unique and the analytic
processes are not ported yet.
"""

from geomesa_tpu_torch.process.knn import knn_search, last_knn_path
from geomesa_tpu_torch.process.tube import tube_select
