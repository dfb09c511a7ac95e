"""Launchers of the port: the step builders (``steps``), the training
driver (``train``) and the serving driver (``serve``)."""
