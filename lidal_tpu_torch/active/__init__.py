"""Active selection: hash-grid NN matching, LiDAL scoring and selection."""
