"""Expression DSL surface of the port (the analog of pyspark.sql.functions)."""
from spark_rapids_tpu_torch.expressions.core import (
    Alias,
    BoundReference,
    Col,
    EvalContext,
    Expression,
    Literal,
    col,
    lit,
)
from spark_rapids_tpu_torch.expressions.arithmetic import (Add, Multiply,
                                                        Subtract)
from spark_rapids_tpu_torch.expressions.predicates import (
    And,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    IsNull,
    LessThan,
    LessThanOrEqual,
    Not,
    Or,
)
from spark_rapids_tpu_torch.expressions.strings import Substring
from spark_rapids_tpu_torch.expressions.casts import Cast
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.expressions.aggregates import (
    Average, Count, Sum, avg, count, sum_)

__all__ = [
    "Add", "Alias", "And", "Average", "BoundReference", "Cast", "Col",
    "Count", "EqualTo", "EvalContext", "Expression", "GreaterThan",
    "GreaterThanOrEqual", "If", "IsNull", "LessThan", "LessThanOrEqual",
    "Literal", "Multiply", "Not", "Or", "Substring", "Subtract", "Sum",
    "avg", "col", "count", "lit", "sum_",
]
