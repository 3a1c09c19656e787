"""Tools of the port: the transform expression language (``convert``)."""
