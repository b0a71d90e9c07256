"""SUN RGB-D tooling and the host input pipeline: the validator and
manifests, the live and packed loaders, the native C++ batch loader, the
synthetic fixture and the prefetching ``InputPipeline``."""
