"""Device operations of the port: the fused scan, the histogram kernel, grouping."""
