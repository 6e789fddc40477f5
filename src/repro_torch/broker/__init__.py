from repro_torch.broker.broker import Broker, Message, MessageQueue  # noqa: F401
