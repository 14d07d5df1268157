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
from spark_rapids_tpu_torch.expressions.arithmetic import (Add, Divide,
                                                        Multiply, Subtract)
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
    Average, BoolAnd, BoolOr, Count, Max, Min, StddevPop, StddevSamp, Sum,
    VariancePop, VarianceSamp, avg, count, max_, min_, stddev, stddev_pop,
    sum_, var_pop, var_samp)

__all__ = [
    "Add", "Alias", "And", "Average", "BoolAnd", "BoolOr", "BoundReference",
    "Cast", "Col", "Count", "Divide", "EqualTo", "EvalContext", "Expression",
    "GreaterThan", "GreaterThanOrEqual", "If", "IsNull", "LessThan",
    "LessThanOrEqual", "Literal", "Max", "Min", "Multiply", "Not", "Or",
    "StddevPop", "StddevSamp", "Substring", "Subtract", "Sum", "VariancePop",
    "VarianceSamp", "avg", "col", "count", "lit", "max_", "min_", "stddev",
    "stddev_pop", "sum_", "var_pop", "var_samp",
]
