"""One module per kind of traffic; a cell's workload file names its kind
and gives its parameters."""
