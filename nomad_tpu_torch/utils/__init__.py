from .codec import to_dict, from_dict, encode, decode
from .ids import generate_uuid

__all__ = ["to_dict", "from_dict", "encode", "decode", "generate_uuid"]
