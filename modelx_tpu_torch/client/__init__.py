"""Client side of the registry (counterpart of ``modelx_tpu/client``): the
typed HTTP client, the push and pull engines and their data-plane
extensions, on the standard library's ``http.client``."""

# register the object-store data-plane extensions beside ``http`` and
# ``file``: a pull or push through an S3- or GCS-backed registry finds them
from modelx_tpu_torch.client import extension_gcs as _extension_gcs  # noqa: F401
from modelx_tpu_torch.client import extension_s3 as _extension_s3  # noqa: F401
