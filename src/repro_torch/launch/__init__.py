"""Launchers of the port: the step builders (``steps``), the training
driver (``train``), the serving driver (``serve``), mesh construction
(``mesh``), allocation-free specs (``specs``), roofline terms
(``roofline``), and the dry run (``dryrun``), its FLOP probe
(``patch_probe``) and its report (``report``)."""
