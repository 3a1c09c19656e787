"""Columnar blocks, the datastore facade and the file store.

Port of ``geomesa_tpu/store``: ``blocks.py``, ``datastore.py``, and the
persistence of ``fs.py`` (``FsDataStore``) with ``partitions.py``,
``journal.py``, ``integrity.py`` and ``metadata.py``.
"""
