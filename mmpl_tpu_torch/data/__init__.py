"""The training data path: datasets, the clip resample, offline encoding
into latent shards, and ODE trajectories from a teacher."""
