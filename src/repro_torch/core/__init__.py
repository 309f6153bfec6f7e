"""SALR core: pruning, tiled-bitmap storage, adapters, the SALR linear
and the execution-plan resolver."""
