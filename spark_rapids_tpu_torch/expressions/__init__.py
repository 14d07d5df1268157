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
from spark_rapids_tpu_torch.expressions.arithmetic import Multiply
from spark_rapids_tpu_torch.expressions.predicates import (
    And,
    GreaterThanOrEqual,
    LessThan,
    LessThanOrEqual,
)
from spark_rapids_tpu_torch.expressions.casts import Cast
from spark_rapids_tpu_torch.expressions.aggregates import Count, Sum, count, sum_

__all__ = [
    "Alias", "And", "BoundReference", "Cast", "Col", "Count", "EvalContext",
    "Expression", "GreaterThanOrEqual", "LessThan", "LessThanOrEqual",
    "Literal", "Multiply", "Sum", "col", "count", "lit", "sum_",
]
