"""Command-line launchers of the port (``repro/launch``): ``serve``,
``train``, ``mesh`` and the dry run (``dryrun``, ``input_specs``,
``hlo_stats``)."""
