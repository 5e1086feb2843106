"""GQ-Fast core: fragment storage, codecs, RQNA algebra, SQL, query execution."""
from .engine import GQFastDatabase, GQFastEngine, PreparedQuery  # noqa: F401
from .schema import EntityTable, RelationshipTable, Schema  # noqa: F401
