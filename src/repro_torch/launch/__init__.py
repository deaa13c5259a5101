"""Launch helpers of the port: the scoring mesh."""
