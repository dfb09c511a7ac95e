"""Launchers of the port: the step builders (``steps``), the training
driver (``train``), the serving driver (``serve``), mesh construction
(``mesh``), allocation-free specs (``specs``) and roofline terms
(``roofline``)."""
