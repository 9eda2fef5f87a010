"""The harness's general parts: the cell's files, seeds, weights, the
trace reduction and the result line."""
