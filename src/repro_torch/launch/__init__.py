"""Launchers: the serving and training entry points, their step builders
(on one device or a mesh), the mesh and its sharding rules, and the
dry-run with its roofline analysis."""
