from .broker import BrokerError, Channel, Connection, Message  # noqa: F401
from .client import QueueClient  # noqa: F401
from .delivery import Delivery  # noqa: F401
from .memory import MemoryBroker  # noqa: F401
