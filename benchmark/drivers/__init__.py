"""Traffic drivers: ``<name>.py`` runs the traffic files whose ``driver`` is ``<name>``."""
