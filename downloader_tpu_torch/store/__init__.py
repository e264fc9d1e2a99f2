from .credentials import Credentials, from_env  # noqa: F401
from .s3 import S3Client, S3Error  # noqa: F401
from .uploader import Uploader, UploadError, UploadResult, object_key  # noqa: F401
