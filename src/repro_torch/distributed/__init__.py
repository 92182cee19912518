"""Distributed-training helpers that run on one device: gradient
compression and fault tolerance.  Sharding and meshes are ROADMAP Queue 1
item 13."""
