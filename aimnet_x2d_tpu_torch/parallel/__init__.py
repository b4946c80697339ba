"""Training over several ranks: the process group (``multihost``), the
(data, graph) rank grid and its collectives (``mesh``), the halo partitioner
of graph shards (``halo``) and the grid's train step (``graph_parallel``)."""
