"""Launch tooling of the port: production meshes (``mesh``), the (arch x
shape) cells (``cells``), the per-device cost counter (``cost``), the dry
run on ``meta`` DTensors (``dryrun``) and the H100 roofline
(``roofline``).  Import the modules themselves."""
