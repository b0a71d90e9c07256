"""SUN RGB-D tooling and the input feeds: the validator and manifests, the
live and packed loaders, the native C++ batch loader, the synthetic
fixture, the prefetching ``InputPipeline`` and the GPU-resident feed
(``DeviceDataset``, ``ChunkedDeviceDataset``, ``DevicePipeline``)."""

from cadepth_tpu_torch.data.device_resident import (  # noqa: F401
    ChunkedDeviceDataset,
    DeviceDataset,
    DevicePipeline,
)
