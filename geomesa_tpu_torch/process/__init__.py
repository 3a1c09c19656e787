"""Analytic processes over the datastore (port of ``geomesa_tpu/process``).

The k-nearest-neighbour search (``knn_search``, whose device top-k runs
the ``knn_topk`` kernel), TubeSelect (``tube_select``), proximity search
(``proximity.py``), route search (``route.py``), the track processes
(``tracks.py``), unique values (``unique.py``) and the WPS-style
analytics (``analytic.py``). Every process but kNN's top-k answers
through ordinary store queries, so it takes the port's device routes.
"""

from geomesa_tpu_torch.process.knn import knn_search, last_knn_path
from geomesa_tpu_torch.process.proximity import proximity_search
from geomesa_tpu_torch.process.tube import tube_select
from geomesa_tpu_torch.process.unique import unique_values
