"""Sketches, the stat spec parser and the write-time stats service.

Port of ``geomesa_tpu/stats``: the sketches and their JSON state
(``sketches.py``), ``parse_stat`` (``parser.py``) and the write-time
sketches of the strategy choice (``service.py``).
"""
